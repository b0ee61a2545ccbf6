"""Public entry points around the kernels (``repro.kernels.ops``): plain
functions, since PyTorch runs eagerly and the port needs no ``jit``.  Each
plans its blocks through the port's planner and routes as its wrapper does:
CPU tensors to the plain version, CUDA tensors to the Hopper kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_cc import matmul_cc
from repro_torch.kernels.ssd_scan import ssd_scan


def matmul(a: torch.Tensor, b: torch.Tensor,
           order: str = "cc") -> torch.Tensor:
    """Cache-conscious blocked matmul: C[m,n] = A[m,k] @ B[k,n]."""
    return matmul_cc(a, b, order=order)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Flash attention over (B, H, S, D) tensors."""
    return flash_attention(q, k, v, causal=causal)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Chunked selective-state-space scan (Mamba2/SSD)."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
