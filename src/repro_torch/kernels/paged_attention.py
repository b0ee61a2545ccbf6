"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

Replaces ``repro.kernels.paged_attention.paged_attention`` (the Pallas TPU
kernel ``_pa_kernel``).  One query token per row attends over the KV stream
its page-table row names, with grouped GQA, causal/window/length masks and
an online softmax across pages; see the CUDA source's header for the design
and what bounds it.

Routing, with no fallback between the two:
  * CPU tensors -> ``kernels.ref.paged_attention_ref``, the plain version;
  * CUDA tensors -> the hand-written kernel, or an exception.  The wrapper
    checks devices, dtypes, contiguity and shapes, allocates the output,
    launches on ``torch.cuda.current_stream()`` and raises when the launch
    reports an error.

``LAUNCHES`` counts kernel launches (never CPU calls), so a run can show
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

#: Kernel launches made by this process.
LAUNCHES = 0

#: Tokens of a page the kernel stages at a time (``kTileTokens``).
TILE_TOKENS = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.paged_attention_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def smem_bytes(group: int, head_dim: int) -> int:
    """Shared memory of one block, as the CUDA kernel lays it out (its
    ``paged_attention_smem_bytes`` reports the same): float32 q and
    accumulator (G x D each), one ``TILE_TOKENS`` tile of K (rows padded
    by one float) and of V, the tile's logits (G x TILE_TOKENS) and the
    softmax state (3 x G).  It does not depend on the page size."""
    g, d, t = group, head_dim, TILE_TOKENS
    return 4 * (2 * g * d + t * (d + 1) + t * d + g * t + 3 * g)


def kernel_smem_bytes(group: int, head_dim: int) -> int:
    """The shared memory the CUDA kernel reports for one block (builds the
    kernel first)."""
    return int(_kernel()[1](group, head_dim))


def paged_attention(
    q: torch.Tensor,            # (S, H, D)  one query token per row
    k_pages: torch.Tensor,      # (P, T, KV, D)  one layer's page pool
    v_pages: torch.Tensor,      # (P, T, KV, D)
    page_table: torch.Tensor,   # (S, NP) int32, entries in [0, P)
    lengths: torch.Tensor,      # (S,) int32  valid tokens incl. current
    window: int = 0,
    page_tokens: Optional[int] = None,
) -> torch.Tensor:
    """One step of attention against the paged KV pool; returns (S, H, D).

    ``page_tokens`` is the plan's page size; when given it must equal the
    pool's second dim -- the kernel streams at the planned page and no
    other granule.
    """
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    s, h, d = q.shape
    p_total, t, n_kv, dk = k_pages.shape
    if page_tokens is not None and t != page_tokens:
        raise ValueError(
            f"pool page_tokens={t} != planned page_tokens={page_tokens}; "
            f"the kernel block must be the planned page")
    if h % n_kv != 0:
        raise ValueError(f"{h} query heads do not group over {n_kv} KV heads")
    if dk != d or page_table.dim() != 2 or page_table.shape[0] != s \
            or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"bad shapes: q {tuple(q.shape)}, pool {tuple(k_pages.shape)}, "
            f"table {tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if all(x.device.type == "cpu" for x in tensors):
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   window=window)
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must be on one CUDA "
                         "device (or all on the CPU); got "
                         f"{[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention needs contiguous tensors")
    if (d * q.element_size()) % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("the kernel loads K/V 16 bytes at a time: the head "
                         "dim must span a multiple of 16 B and the pools "
                         "must be 16-byte aligned")
    out = torch.empty_like(q)
    if s == 0:
        return out
    fn, kernel_smem = _kernel()
    smem = kernel_smem(h // n_kv, d)
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"{h // n_kv} query heads per KV head at head dim "
                         f"{d} need {smem} B of shared memory per block; "
                         f"a block may use {limit}")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            s, h, n_kv, d, t, page_table.shape[1], int(window),
            1.0 / math.sqrt(d), _DTYPES[q.dtype], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
