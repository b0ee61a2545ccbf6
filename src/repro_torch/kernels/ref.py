"""Plain PyTorch versions of the hand-written kernels: the CPU path of each
wrapper, and what the tests and ``chip_smoke.py`` hold each kernel to."""

from __future__ import annotations

import math
from typing import Optional

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


def paged_attention_split_ref(
    q: torch.Tensor,           # (S, H, D)
    k_pages: torch.Tensor,     # (P, T, KV, D)
    v_pages: torch.Tensor,     # (P, T, KV, D)
    page_table: torch.Tensor,  # (S, NP) int
    lengths: torch.Tensor,     # (S,) int
    window: int = 0,
    split_pages: int = 1,
    return_partials: bool = False,
):
    """Paged decode attention in the split body's own decomposition: each
    row's KV stream is cut into splits of ``split_pages`` whole pages; each
    split gives a float32 partial ``(m, l, acc)`` -- its masked logits'
    max, the sum of ``exp(logit - m)`` and the unnormalised ``P V`` with P
    rounded to V's dtype for the product -- and the partials merge in split
    order.  A split with no live key is ``(-inf, 0, 0)``.

    With ``return_partials`` the result is ``(out, m, l, acc)`` with m and
    l (S, KV, splits, G) and acc (S, KV, splits, G, D)."""
    s, h, d = q.shape
    t, kv = k_pages.shape[1], k_pages.shape[2]
    g = h // kv
    n_pages = page_table.shape[1]
    splits = -(-max(1, n_pages) // split_pages)
    span = split_pages * t
    idx = page_table.long()
    k = k_pages[idx].reshape(s, -1, kv, d).float()     # (S, NP*T, KV, D)
    v = v_pages[idx].reshape(s, -1, kv, d)
    pad = splits * span - k.shape[1]
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(s, kv, g, d).float()
    logits = torch.einsum("skgd,stkd->skgt", qg, k) * scale
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    qpos = lengths.long()[:, None] - 1
    mask = (kpos <= qpos) & (kpos < n_pages * t)
    if window:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    logits = logits.reshape(s, kv, g, splits, span).transpose(2, 3)
    m = logits.amax(-1)                                # (S, KV, splits, G)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe[..., None])          # 0 where masked
    l = p.sum(-1)
    vs = v.reshape(s, splits, span, kv, d).float()
    acc = torch.einsum("skcgt,sctkd->skcgd", p.to(v.dtype).float(), vs)
    big = m.amax(2, keepdim=True)                      # (S, KV, 1, G)
    big_safe = torch.where(torch.isinf(big), torch.zeros_like(big), big)
    w = torch.exp(m - big_safe)                        # 0 for empty splits
    tot_l = (l * w).sum(2)                             # (S, KV, G)
    tot_a = (acc * w[..., None]).sum(2)                # (S, KV, G, D)
    out = (tot_a / tot_l.clamp_min(1e-30)[..., None]).reshape(s, h, d)
    out = out.to(q.dtype)
    if return_partials:
        return out, m, l, acc
    return out


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
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
    return_final: bool = False,
):
    """The sequential SSD recurrence, one step per token
    (``repro.kernels.ref.ssd_ref``, whose ``lax.scan`` becomes a Python
    loop): ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T``,
    ``y_t = S_t C_t``, in float32 from ``init_state`` (zeros when None),
    rounded to x's dtype at the end.  Returns y (B, S, H, P); with
    ``return_final`` also the final state (B, H, P, N) float32."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    a = A.float()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float().clone())
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                  # (B, H)
        upd = (dtt[:, :, None, None] * x[:, t].float()[..., None]
               * Bm[:, t].float()[:, None, None, :])            # (B,H,P,N)
        state = state * torch.exp(dtt * a)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    y = (torch.stack(ys, dim=1) if ys else x.float()).to(x.dtype)
    return (y, state) if return_final else y


def ssd_passes_ref(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H)
    A: torch.Tensor,        # (H,) negative
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    chunk: int = 64,
    return_states: bool = False,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
    return_final: bool = False,
):
    """The SSD scan in the tensor-core body's three passes, float32, with
    the sequence padded to whole chunks (dt = 0 and zeros past the end, so
    padded steps neither decay nor add to the state).  With ``cum`` the
    cumulative sum of ``dt * A`` inside a chunk:

      1. chunk states ``S_c = (B o exp(cum_Q - cum) o dt)^T x`` (N x P per
         head) and each chunk's total log decay ``cum_Q``;
      2. state passing in chunk order:
         ``S_prev[c] = exp(cum_Q[c-1]) S_prev[c-1] + S_c[c-1]``, from
         ``init_state`` (zeros when None; (B, H, P, N), the reference's
         layout, transposed to the passes' N x P);
      3. outputs ``y = ((C B^T) o L_h) (dt o x) + exp(cum) o (C S_prev)``
         with ``L_h[i, j] = exp(cum_i - cum_j)`` for ``j <= i``, else 0.

    Returns y (B, S, H, P) in x's dtype; with ``return_final`` next the
    final state (B, H, P, N) float32; with ``return_states`` then the
    chunk states (B, nc, H, N, P), the states entering each chunk (same
    shape) and the totals (B, nc, H)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = max(8, min(chunk, s))
    pad = (-s) % q
    xf, dtf = x.float(), dt.float()
    bf, cf = Bm.float(), Cm.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = xf.reshape(b, nc, q, h, p)
    dtc = dtf.reshape(b, nc, q, h)
    bc = bf.reshape(b, nc, q, n)
    cc = cf.reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * A.float(), dim=2)          # (B, nc, Q, H)
    total = cum[:, :, -1]                               # (B, nc, H)
    # 1. chunk states
    w = torch.exp(total[:, :, None] - cum) * dtc        # (B, nc, Q, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, w, xc)
    # 2. state passing
    prev = torch.zeros_like(states)
    run = (torch.zeros_like(states[:, 0]) if init_state is None
           else init_state.float().transpose(-1, -2))
    for c in range(nc):
        prev[:, c] = run
        run = torch.exp(total[:, c])[..., None, None] * run + states[:, c]
    # 3. outputs
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)        # (B, nc, Q, Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                    torch.zeros_like(seg))
    wgt = cb[..., None] * L * dtc[:, :, None, :, :]     # (B,nc,i,j,H)
    y = torch.einsum("bcijh,bcjhp->bcihp", wgt, xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcin,bchnp->bcihp", cc, prev)
    y = y.reshape(b, nc * q, h, p)[:, :s].to(x.dtype)
    out = [y]
    if return_final:
        out.append(run.transpose(-1, -2).contiguous())
    if return_states:
        out += [states, prev, total]
    return tuple(out) if len(out) > 1 else y
