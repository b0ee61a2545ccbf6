"""Mamba2 / SSD chunked scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``).  Returns ``y`` only, as the reference does (the state in
and out belongs to ``ssd_chunked``, ported with the ``hybrid_ssm``
slice).  The chunk is the planner's partition of the time axis
(``models.mamba2.choose_chunk``); see the CUDA source's header for the
design and what bounds it.

Routing, with no fallback between the two:
  * CPU tensors -> ``kernels.ref.ssd_ref``, the plain version;
  * CUDA tensors -> the hand-written kernel, or an exception.

``LAUNCHES`` counts kernel launches (never CPU calls).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref

#: Kernel launches made by this process.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def kernel_smem_bytes(chunk: int, head_dim: int, state_dim: int) -> int:
    """The shared memory the CUDA kernel reports for one block (builds the
    kernel first)."""
    return int(_kernel()[1](chunk, head_dim, state_dim))


def ssd_scan(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H)   post-softplus
    A: torch.Tensor,        # (H,)        negative
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    chunk: int = 64,
) -> torch.Tensor:
    """Returns y (B, S, H, P) in x's dtype.  The chunk is clamped to
    ``max(8, min(chunk, S))``; a ragged final chunk is masked."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P); got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or Bm.dim() != 3 or tuple(Bm.shape[:2]) != (b, s) \
            or Cm.shape != Bm.shape:
        raise ValueError(
            f"bad shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    n = Bm.shape[-1]
    q = max(8, min(chunk, s))
    tensors = (x, dt, A, Bm, Cm)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_ref(x, dt, A, Bm, Cm)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("ssd_scan: all tensors must be on one CUDA device "
                         "(or all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B and C of "
                        f"one dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan needs contiguous tensors")
    # The kernel reads dt and A in float32 (the Pallas kernel casts both).
    dt32 = dt.to(torch.float32).contiguous()
    a32 = A.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn, smem_bytes = _kernel()
    smem = smem_bytes(q, p, n)
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"chunk {q} at P={p}, N={n} needs {smem} B of "
                         f"shared memory per block; a block may use {limit}")
    rc = fn(x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), b, s, h, p, n, q, _DTYPES[x.dtype],
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return y
