"""Plain PyTorch versions of the hand-written kernels: the CPU path of each
wrapper, and what the tests and ``chip_smoke.py`` hold each kernel to."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(
    q: torch.Tensor,           # (S, H, D)  one query token per row
    k_pages: torch.Tensor,     # (P, T, KV, D)  page pool, one layer
    v_pages: torch.Tensor,     # (P, T, KV, D)
    page_table: torch.Tensor,  # (S, NP) int  physical page per logical page
    lengths: torch.Tensor,     # (S,) int  valid tokens incl. the current one
    window: int = 0,
) -> torch.Tensor:
    """Paged decode attention, defined by gather (``repro.kernels.ref.
    paged_attention_ref``): materialize each row's logical KV stream
    through its page table, then grouped GQA attention with per-row
    causal/window/length masks.  A row with ``lengths == 0`` is all zeros,
    as in the kernel."""
    s, h, d = q.shape
    kv = k_pages.shape[2]
    g = h // kv
    idx = page_table.long()
    k = k_pages[idx].reshape(s, -1, kv, d)            # (S, NP*T, KV, D)
    v = v_pages[idx].reshape(s, -1, kv, d)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(s, kv, g, d)
    # Logits in float32 from the inputs' values, as the kernel forms them.
    logits = torch.einsum("skgd,stkd->skgt", qg.float(), k.float()) * scale
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    qpos = lengths.long()[:, None] - 1                # (S, 1)
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("skgt,stkd->skgd", probs, v).reshape(s, h, d)
    return out.masked_fill((lengths <= 0)[:, None, None], 0)
