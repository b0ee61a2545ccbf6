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


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` summed in float32 and rounded to A's dtype once
    (``repro.kernels.ref.matmul_ref``)."""
    return (a.float() @ b.float()).to(a.dtype)


def flash_attention_ref(
    q: torch.Tensor,        # (B, H, Sq, D)
    k: torch.Tensor,        # (B, H, Sk, D)
    v: torch.Tensor,        # (B, H, Sk, D)
    causal: bool = True,
) -> torch.Tensor:
    """Dense attention (``repro.kernels.ref.flash_attention_ref``): causal
    with the sequence ends aligned (query i sees keys <= i + Sk - Sq).
    Logits in float32 from the inputs' values, as the kernel forms them;
    probabilities rounded to V's dtype before the product, as in the
    reference.  A row that sees no key is undefined."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = torch.arange(sk, device=q.device)[None, :] <= qpos
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(),
                        v.float()).to(q.dtype)


def ssd_ref(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H)
    A: torch.Tensor,        # (H,) negative
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
) -> torch.Tensor:
    """The sequential SSD recurrence, one step per token
    (``repro.kernels.ref.ssd_ref``, whose ``lax.scan`` becomes a Python
    loop): ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T``,
    ``y_t = S_t C_t``, in float32, rounded to x's dtype at the end."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    a = A.float()
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                  # (B, H)
        upd = (dtt[:, :, None, None] * x[:, t].float()[..., None]
               * Bm[:, t].float()[:, None, None, :])            # (B,H,P,N)
        state = state * torch.exp(dtt * a)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype)                   # (B,S,H,P)
