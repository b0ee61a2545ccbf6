"""Flash attention: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel ``_fa_kernel``).  Attention over (B, H, S, D) tensors with the
planner's blocks (``core.autotile.plan_attention`` when no plan is given,
then ``clamp_attention_plan``), an online softmax over ``block_kv``
partitions, causal with the sequence ends aligned; see the CUDA source's
header for the design and what bounds it.

Routing, with no fallback between the two:
  * CPU tensors -> ``kernels.ref.flash_attention_ref``, the plain version;
  * CUDA tensors -> the hand-written kernel, or an exception.

``LAUNCHES`` counts kernel launches (never CPU calls).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.autotile import (MAX_THREADS, AttentionTilePlan,
                                       _attn_threads, clamp_attention_plan,
                                       plan_attention)
from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: Kernel launches made by this process.
LAUNCHES = 0

#: Head dims the kernel takes: 16, or whole 32-dim slices a power of two.
HEAD_DIMS = (16, 32, 64, 128, 256)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.flash_attention_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def kernel_smem_bytes(block_kv: int, head_dim: int,
                      dtype: torch.dtype) -> int:
    """The shared memory the CUDA kernel reports for one block (builds the
    kernel first)."""
    return int(_kernel()[1](block_kv, head_dim, _DTYPES[dtype]))


def flash_attention(
    q: torch.Tensor,                    # (B, H, Sq, D)
    k: torch.Tensor,                    # (B, H, Sk, D)
    v: torch.Tensor,                    # (B, H, Sk, D)
    causal: bool = True,
    plan: Optional[AttentionTilePlan] = None,
    return_plan: bool = False,
):
    """With ``return_plan`` the result is ``(out, effective_plan)``: the
    plan records the blocks the kernel ran, and when the sequence forces a
    clamp below the plan's choice its ``source`` carries ``+clamped``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if plan is None:
        plan = plan_attention(sq, sk, d, dtype_bytes=q.element_size())
    plan = clamp_attention_plan(plan, sq, sk, dtype_bytes=q.element_size())
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        out = flash_attention_ref(q, k, v, causal=causal)
        return (out, plan) if return_plan else out
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("flash_attention: all tensors must be on one CUDA "
                         "device (or all on the CPU); got "
                         f"{[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention needs contiguous tensors")
    if d not in HEAD_DIMS or any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} and "
                         f"16-byte aligned tensors; got D={d}")
    bq, bkv = plan.block_q, plan.block_kv
    if _attn_threads(bq, d) > MAX_THREADS:
        raise ValueError(f"block_q={bq} at D={d} needs "
                         f"{_attn_threads(bq, d)} threads; at most "
                         f"{MAX_THREADS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return (out, plan) if return_plan else out
    fn, smem_bytes = _kernel()
    smem = smem_bytes(bkv, d, _DTYPES[q.dtype])
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"block_kv={bkv} at D={d} needs {smem} B of shared "
                         f"memory per block; a block may use {limit}")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, sk, d, bq, bkv, int(causal), 1.0 / math.sqrt(d),
            _DTYPES[q.dtype], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return (out, plan) if return_plan else out
