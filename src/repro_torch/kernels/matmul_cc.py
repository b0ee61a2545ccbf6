"""Cache-conscious blocked matmul: the wrapper of ``csrc/matmul_cc.cu``.

Replaces ``repro.kernels.matmul_cc.matmul_cc`` (the Pallas TPU kernel
``_mm_kernel``).  ``C = A @ B`` with the planner's tile (``core.autotile``,
through ``core.plan.leaf_matmul_plan`` when no plan is given), an f32
accumulator over the K stream, and the ``cc`` (row-major) or ``srrc``
(serpentine over N on odd M rows) mapping from block id to output tile;
see the CUDA source's header for the design and what bounds it.

Routing, with no fallback between any two:
  * CPU tensors -> ``kernels.ref.matmul_ref``, the plain version;
  * CUDA tensors -> the hand-written kernel's body that ``matmul_path``
    names for the shape and dtype (``"wgmma"``: bf16 with K and N
    multiples of 8, on the tensor cores; ``"simt"``: the rest, on the
    CUDA cores), or an exception.

``LAUNCHES_WGMMA`` and ``LAUNCHES_SIMT`` count kernel launches by body
(never CPU calls); ``LAUNCHES`` is their sum.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.autotile import (MAX_THREADS, MM_MICRO,
                                       MatmulTilePlan, matmul_path,
                                       matmul_tile_ok, plan_matmul)
from repro_torch.core.plan import leaf_matmul_plan
from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

#: Kernel launches made by this process, by body, and in all.
LAUNCHES_WGMMA = 0
LAUNCHES_SIMT = 0
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "wgmma": 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("matmul_cc")
        fn = lib.matmul_cc_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.matmul_cc_smem_bytes
        smem.argtypes = [ctypes.c_int] * 5
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def kernel_smem_bytes(bm: int, bk: int, bn: int, dtype: torch.dtype,
                      path: str) -> int:
    """The shared memory the CUDA kernel's ``path`` body reports for one
    block (builds the kernel first)."""
    return int(_kernel()[1](bm, bk, bn, _DTYPES[dtype], _PATHS[path]))


def _count(path: str) -> None:
    global LAUNCHES, LAUNCHES_SIMT, LAUNCHES_WGMMA
    if path == "wgmma":
        LAUNCHES_WGMMA += 1
    else:
        LAUNCHES_SIMT += 1
    LAUNCHES += 1


def matmul_cc(
    a: torch.Tensor,                    # (M, K)
    b: torch.Tensor,                    # (K, N)
    plan: Optional[MatmulTilePlan] = None,
    order: str = "cc",
    path: Optional[str] = None,
) -> torch.Tensor:
    """Blocked matmul with the planner's tile; returns (M, N) in A's
    dtype.  Ragged edges are masked in the kernel.  ``path="simt"`` runs
    the CUDA-core body where ``matmul_path`` would pick wgmma (to compare
    the two); a body that cannot take the shape raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    routed = matmul_path(m, k, n, a.dtype)
    if path not in (None, "simt", routed):
        raise ValueError(f"matmul_cc: the {path} body cannot take "
                         f"{a.dtype} {(m, k, n)}")
    path = path or routed
    if plan is None and path == routed:
        plan = leaf_matmul_plan(m, k, n, dtype_bytes=a.element_size(),
                                order=order)
    elif plan is None:
        plan = plan_matmul(m, k, n, dtype_bytes=a.element_size(),
                           order=order, path=path)
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
    _build.refuse_grad("matmul_cc", (a, b))
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul_cc takes float32 or bfloat16 operands of "
                        f"one dtype; got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cc needs contiguous operands")
    bm, bk, bn = plan.bm, plan.bk, plan.bn
    if path == "wgmma":
        if not matmul_tile_ok(bm, bk, bn, path):
            raise ValueError(f"tile {bm}x{bk}x{bn} on the wgmma path: bm "
                             "must be 64 or 128, bk and bn multiples of 64 "
                             "up to 256")
        if a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("the wgmma path needs 16-byte aligned operands "
                             "(TMA)")
    elif not matmul_tile_ok(bm, bk, bn, path) or \
            (bm // MM_MICRO) * (bn // MM_MICRO) > MAX_THREADS:
        raise ValueError(f"tile {bm}x{bk}x{bn}: bm and bn must be multiples "
                         f"of {MM_MICRO} with (bm/8)*(bn/8) <= {MAX_THREADS} "
                         "threads")
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    fn, smem_bytes = _kernel()
    smem = smem_bytes(bm, bk, bn, _DTYPES[a.dtype], _PATHS[path])
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"tile {bm}x{bk}x{bn} needs {smem} B of shared "
                         f"memory per block on the {path} path; a block may "
                         f"use {limit}")
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, bm, bk, bn,
            int(serpentine), _DTYPES[a.dtype], _PATHS[path], a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul_cc kernel launch failed ({path} body): "
                           f"error {rc}")
    _count(path)
    return out
