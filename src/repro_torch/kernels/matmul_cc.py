"""Cache-conscious blocked matmul: the wrapper of ``csrc/matmul_cc.cu``.

Replaces ``repro.kernels.matmul_cc.matmul_cc`` (the Pallas TPU kernel
``_mm_kernel``).  ``C = A @ B`` with the planner's tile (``core.autotile``,
through ``core.plan.leaf_matmul_plan`` when no plan is given), an f32
accumulator over the K stream, and the ``cc`` (row-major) or ``srrc``
(serpentine over N on odd M rows) mapping from block id to output tile;
see the CUDA source's header for the design and what bounds it.

Routing, with no fallback between the two:
  * CPU tensors -> ``kernels.ref.matmul_ref``, the plain version;
  * CUDA tensors -> the hand-written kernel, or an exception.

``LAUNCHES`` counts kernel launches (never CPU calls).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.autotile import MM_MICRO, MAX_THREADS, MatmulTilePlan
from repro_torch.core.plan import leaf_matmul_plan
from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

#: Kernel launches made by this process.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("matmul_cc")
        fn = lib.matmul_cc_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.matmul_cc_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def kernel_smem_bytes(bm: int, bk: int, bn: int, dtype: torch.dtype) -> int:
    """The shared memory the CUDA kernel reports for one block (builds the
    kernel first)."""
    return int(_kernel()[1](bm, bk, bn, _DTYPES[dtype]))


def matmul_cc(
    a: torch.Tensor,                    # (M, K)
    b: torch.Tensor,                    # (K, N)
    plan: Optional[MatmulTilePlan] = None,
    order: str = "cc",
) -> torch.Tensor:
    """Blocked matmul with the planner's tile; returns (M, N) in A's
    dtype.  Ragged edges are masked in the kernel."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if plan is None:
        plan = leaf_matmul_plan(m, k, n, dtype_bytes=a.element_size(),
                                order=order)
    if (plan.m, plan.k, plan.n) != (m, k, n):
        raise ValueError(f"plan is for {(plan.m, plan.k, plan.n)}, the "
                         f"operands are {(m, k, n)}")
    serpentine = plan.order == "srrc" or order == "srrc"
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError("matmul_cc: both tensors must be on one CUDA "
                         f"device (or both on the CPU); got {a.device}, "
                         f"{b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul_cc takes float32 or bfloat16 operands of "
                        f"one dtype; got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cc needs contiguous operands")
    bm, bk, bn = plan.bm, plan.bk, plan.bn
    threads = (bm // MM_MICRO) * (bn // MM_MICRO)
    if bm % MM_MICRO or bn % MM_MICRO or bk < 1 or threads > MAX_THREADS:
        raise ValueError(f"tile {bm}x{bk}x{bn}: bm and bn must be multiples "
                         f"of {MM_MICRO} with (bm/8)*(bn/8) <= {MAX_THREADS} "
                         "threads")
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    fn, smem_bytes = _kernel()
    smem = smem_bytes(bm, bk, bn, _DTYPES[a.dtype])
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"tile {bm}x{bk}x{bn} needs {smem} B of shared "
                         f"memory per block; a block may use {limit}")
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, bm, bk, bn,
            int(serpentine), _DTYPES[a.dtype], a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul_cc kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
