"""Flash attention: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel ``_fa_kernel``).  Attention over (B, H, S, D) tensors with the
planner's blocks (``core.autotile.plan_attention`` when no plan is given,
then ``clamp_attention_plan``), an online softmax over ``block_kv``
partitions, causal with the sequence ends aligned; see the CUDA source's
header for the design and what bounds it.

Routing, with no fallback between any two:
  * CPU tensors -> ``kernels.ref.flash_attention_ref``, the plain version;
  * CUDA tensors -> the hand-written kernel's body that ``attention_path``
    names (``"wgmma"``: bf16 at head dims 64 and 128, on the tensor cores;
    ``"simt"``: the rest, on the CUDA cores), or an exception.

``LAUNCHES_WGMMA`` and ``LAUNCHES_SIMT`` count kernel launches by body
(never CPU calls); ``LAUNCHES`` is their sum.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.autotile import (FA_WGMMA_BLOCKS, MAX_THREADS,
                                       AttentionTilePlan, _attn_threads,
                                       attention_path, clamp_attention_plan,
                                       plan_attention)
from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: Kernel launches made by this process, by body, and in all.
LAUNCHES_WGMMA = 0
LAUNCHES_SIMT = 0
LAUNCHES = 0

#: Head dims the simt body takes: 16, or whole 32-dim slices a power of
#: two.  The wgmma body takes 64 and 128 (``attention_path``).
HEAD_DIMS = (16, 32, 64, 128, 256)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "wgmma": 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.flash_attention_smem_bytes
        smem.argtypes = [ctypes.c_int] * 5
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def kernel_smem_bytes(block_q: int, block_kv: int, head_dim: int,
                      dtype: torch.dtype, path: str) -> int:
    """The shared memory the CUDA kernel's ``path`` body reports for one
    block (builds the kernel first)."""
    return int(_kernel()[1](block_q, block_kv, head_dim, _DTYPES[dtype],
                            _PATHS[path]))


def _count(path: str) -> None:
    global LAUNCHES, LAUNCHES_SIMT, LAUNCHES_WGMMA
    if path == "wgmma":
        LAUNCHES_WGMMA += 1
    else:
        LAUNCHES_SIMT += 1
    LAUNCHES += 1


def flash_attention(
    q: torch.Tensor,                    # (B, H, Sq, D)
    k: torch.Tensor,                    # (B, H, Sk, D)
    v: torch.Tensor,                    # (B, H, Sk, D)
    causal: bool = True,
    plan: Optional[AttentionTilePlan] = None,
    return_plan: bool = False,
    path: Optional[str] = None,
):
    """With ``return_plan`` the result is ``(out, effective_plan)``: the
    plan records the blocks the kernel ran, and when the sequence forces a
    clamp below the plan's choice its ``source`` carries ``+clamped``.
    ``path="simt"`` runs the CUDA-core body where ``attention_path`` would
    pick wgmma (to compare the two); a body that cannot take the shape
    raises."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    routed = attention_path(sq, sk, d, q.dtype)
    if path not in (None, "simt", routed):
        raise ValueError(f"flash_attention: the {path} body cannot take "
                         f"{q.dtype} at D={d}")
    path = path or routed
    if plan is None:
        plan = plan_attention(sq, sk, d, dtype_bytes=q.element_size(),
                              path=None if path == routed else path)
    plan = clamp_attention_plan(plan, sq, sk, dtype_bytes=q.element_size(),
                                path=path)
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        out = flash_attention_ref(q, k, v, causal=causal)
        return (out, plan) if return_plan else out
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("flash_attention: all tensors must be on one CUDA "
                         "device (or all on the CPU); got "
                         f"{[str(x.device) for x in tensors]}")
    _build.refuse_grad("flash_attention", tensors)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention needs contiguous tensors")
    if d not in HEAD_DIMS or any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} and "
                         f"16-byte aligned tensors; got D={d}")
    bq, bkv = plan.block_q, plan.block_kv
    if path == "wgmma":
        if bq not in FA_WGMMA_BLOCKS or bkv not in FA_WGMMA_BLOCKS:
            raise ValueError(f"blocks {bq}/{bkv} on the wgmma path: block_q "
                             f"and block_kv must be in {FA_WGMMA_BLOCKS}")
    elif _attn_threads(bq, d) > MAX_THREADS:
        raise ValueError(f"block_q={bq} at D={d} needs "
                         f"{_attn_threads(bq, d)} threads; at most "
                         f"{MAX_THREADS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return (out, plan) if return_plan else out
    fn, smem_bytes = _kernel()
    smem = smem_bytes(bq, bkv, d, _DTYPES[q.dtype], _PATHS[path])
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"blocks {bq}/{bkv} at D={d} need {smem} B of "
                         f"shared memory per block on the {path} path; a "
                         f"block may use {limit}")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, sk, d, bq, bkv, int(causal), 1.0 / math.sqrt(d),
            _DTYPES[q.dtype], _PATHS[path], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({path} "
                           f"body): error {rc}")
    _count(path)
    return (out, plan) if return_plan else out
