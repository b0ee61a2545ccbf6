"""Mamba2 / SSD chunked scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``).  Returns ``y``, as the reference does, and on request
takes the state before the first step (``init_state``) and returns the
one after the last (``return_final``), both ``(B, H, P, N)`` float32 as
the reference's cache holds them: what ``models.mamba2.mamba2_block``
carries from one prefill chunk to the next.  The chunk is the planner's
partition of the time axis (``models.mamba2.choose_chunk``); a call that
fits in one chunk rounds it up to whole 16s where that makes a tc shape
(``call_chunk``), so the 8-token prefill chunks of zamba2-1.2b run on the
tensor cores with their tail masked.  See the CUDA source's header for
the design and what bounds it.

Routing, with no fallback between any two:
  * CPU tensors -> ``kernels.ref.ssd_ref``, the plain version;
  * CUDA tensors -> the kernel's body that ``ssd_path`` names (``"tc"``:
    bf16 with P in 16/32/64/128, N a multiple of 16 up to 128 and the
    chunk a multiple of 16 up to 256 -- three launches, chunk states,
    state passing and outputs, on the tensor cores, with a float32 state
    workspace the wrapper allocates; ``"simt"``: the rest, on the CUDA
    cores), or an exception.

``LAUNCHES_TC`` and ``LAUNCHES_SIMT`` count kernel launches by body (one
per call, however many CUDA kernels the body runs; never CPU calls);
``LAUNCHES`` is their sum.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref

#: Kernel launches made by this process, by body, and in all.
LAUNCHES_TC = 0
LAUNCHES_SIMT = 0
LAUNCHES = 0

#: What the tc body takes: head dims (one template each), the largest
#: state dim, the largest chunk; P, N and the chunk are whole 16s (mma).
TC_HEAD_DIMS = (16, 32, 64, 128)
TC_MAX_STATE = 128
TC_MAX_CHUNK = 256
#: The tc body's pass-3 blocks: rows of a panel (one 16-row tile per
#: warp), padding of a staged bf16 row; the most heads one block of
#: passes 1 and 3 holds (the largest divisor of H up to it).
TC_PANEL = 128
TC_PAD = 8
TC_MAX_HEADS_PER_BLOCK = 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "tc": 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def ssd_path(dtype: torch.dtype, chunk: int, head_dim: int,
             state_dim: int) -> str:
    """The body a shape takes on the card at the (clamped) ``chunk``:
    ``"tc"`` for bf16 with P in ``TC_HEAD_DIMS``, N a multiple of 16 up to
    ``TC_MAX_STATE`` and the chunk a multiple of 16 up to ``TC_MAX_CHUNK``;
    ``"simt"`` otherwise."""
    if (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            and state_dim % 16 == 0 and 16 <= state_dim <= TC_MAX_STATE
            and chunk % 16 == 0 and 16 <= chunk <= TC_MAX_CHUNK):
        return "tc"
    return "simt"


def call_chunk(dtype: torch.dtype, chunk: int, seq_len: int, head_dim: int,
               state_dim: int) -> int:
    """The chunk a call of ``seq_len`` steps runs at: ``chunk`` clamped to
    ``max(8, min(chunk, seq_len))``.  A call that fits in one chunk (a
    short call, such as an 8-token prefill chunk) rounds it up to whole
    16s where that makes it a tc shape whose block fits shared memory:
    the rows past the call are masked, as a ragged final chunk's are."""
    q = max(8, min(chunk, seq_len))
    if q >= seq_len and q % 16:
        from repro_torch.models.mamba2 import ssd_workset_bytes

        r = -(-q // 16) * 16
        if ssd_path(dtype, r, head_dim, state_dim) == "tc" and \
                ssd_workset_bytes(r, head_dim, state_dim, "tc") \
                <= h100_spec().smem_bytes:
            return r
    return q


def kernel_smem_bytes(chunk: int, head_dim: int, state_dim: int,
                      path: str = "tc") -> int:
    """The shared memory the CUDA kernel's ``path`` body reports for one
    block -- for tc the largest block of its three passes (builds the
    kernel first)."""
    return int(_kernel()[1](chunk, head_dim, state_dim, _PATHS[path]))


def _count(path: str) -> None:
    global LAUNCHES, LAUNCHES_SIMT, LAUNCHES_TC
    if path == "tc":
        LAUNCHES_TC += 1
    else:
        LAUNCHES_SIMT += 1
    LAUNCHES += 1


def ssd_scan(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H)   post-softplus
    A: torch.Tensor,        # (H,)        negative
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    chunk: int = 64,
    path: Optional[str] = None,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N) float32
    return_final: bool = False,
):
    """Returns y (B, S, H, P) in x's dtype, and with ``return_final`` the
    pair ``(y, final_state)``, the state (B, H, P, N) float32 after the
    last step.  The scan starts from ``init_state`` (zeros when None).
    The chunk is ``call_chunk``'s; a ragged final chunk is masked.
    ``path="simt"`` runs the CUDA-core body where ``ssd_path`` would pick
    tc (to compare the two); a body that cannot take the shape raises."""
    if any(isinstance(t, DTensor)
           for t in (x, dt, A, Bm, Cm, init_state)):
        raise TypeError("ssd_scan takes local tensors, not DTensors: on a "
                        "mesh call it on each rank's shard "
                        "(models.mamba2._chunked_scan does)")
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
    if init_state is not None and tuple(init_state.shape) != (b, h, p, n):
        raise ValueError(f"init_state must be (B, H, P, N) = "
                         f"{(b, h, p, n)}; got {tuple(init_state.shape)}")
    q = call_chunk(x.dtype, chunk, s, p, n)
    routed = ssd_path(x.dtype, q, p, n)
    if path not in (None, "simt", routed):
        raise ValueError(f"ssd_scan: the {path} body cannot take {x.dtype} "
                         f"at P={p}, N={n}, chunk {q}")
    path = path or routed
    tensors = (x, dt, A, Bm, Cm) + (() if init_state is None
                                    else (init_state,))
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_ref(x, dt, A, Bm, Cm, init_state=init_state,
                       return_final=return_final)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("ssd_scan: all tensors must be on one CUDA device "
                         "(or all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    _build.refuse_grad("ssd_scan", tensors)
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B and C of "
                        f"one dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if init_state is not None and init_state.dtype != torch.float32:
        raise TypeError(f"init_state must be float32; got "
                        f"{init_state.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan needs contiguous tensors")
    # The kernel reads dt and A in float32 (the Pallas kernel casts both).
    dt32 = dt.to(torch.float32).contiguous()
    a32 = A.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    final = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if return_final else None)
    if y.numel() == 0:
        if final is not None and init_state is not None:
            final.copy_(init_state)
        elif final is not None:
            final.zero_()
        return (y, final) if return_final else y
    if path == "tc" and any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("the tc body copies x, B and C 16 bytes at a time: "
                         "they must be 16-byte aligned")
    fn, smem_bytes = _kernel()
    smem = smem_bytes(q, p, n, _PATHS[path])
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"chunk {q} at P={p}, N={n} needs {smem} B of "
                         f"shared memory per block on the {path} path; a "
                         f"block may use {limit}")
    states = totals = None
    if path == "tc":
        nc = -(-s // q)
        states = torch.empty((b, nc, h, n, p), dtype=torch.float32,
                             device=x.device)
        totals = torch.empty((b, nc, h), dtype=torch.float32,
                             device=x.device)
    rc = fn(x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(),
            0 if states is None else states.data_ptr(),
            0 if totals is None else totals.data_ptr(),
            0 if init_state is None else init_state.data_ptr(),
            0 if final is None else final.data_ptr(),
            b, s, h, p, n, q, _DTYPES[x.dtype], _PATHS[path],
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed ({path} body): "
                           f"CUDA error {rc}")
    _count(path)
    return (y, final) if return_final else y
