"""xLSTM blocks (arXiv:2405.04517; the port of ``repro.models.xlstm``):
the chunkwise-parallel mLSTM (matrix memory, exponential gating,
stabiliser) and the sequential sLSTM (scalar memory with recurrent gate
mixing).

The mLSTM's prefill path is chunkwise -- a stabilised (Q x Q) intra-chunk
tile plus a cross-chunk (C, n, m) state carried from chunk to chunk; the
chunks run as a Python loop where the reference runs ``lax.scan``.  The
step form (``mlstm_step``) serves decode.  ``slstm_scan`` is a per-token
recurrence, a Python loop over the call's tokens here (``lax.scan`` in the
reference).  Every state leaf is float32 and laid out as the reference's,
so caches compare leaf for leaf.  All of it is plain torch: the reference
runs no Pallas kernel here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.mamba2 import causal_conv1d
from repro_torch.models.params import ParamSpec

NEG = -1e30

State = Tuple[torch.Tensor, ...]


def _round128(x: float) -> int:
    """Projection dims rounded to lane multiples, as the reference sizes
    them."""
    return max(128, int(-(-x // 128)) * 128)


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel + sequential step
# ---------------------------------------------------------------------------


def mlstm_chunkwise(
    q: torch.Tensor,        # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,    # (B, S, H) input-gate pre-activations
    f_pre: torch.Tensor,    # (B, S, H) forget-gate pre-activations
    chunk: int,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, State]:
    """Stabilised chunkwise mLSTM.  Returns ``(h (B, S, H, D), (C, n, m))``
    with ``C`` (B, H, D, D), ``n`` (B, H, D) and ``m`` (B, H) in
    float32."""
    b, s, h, d = q.shape
    qs = min(chunk, s)
    pad = (-s) % qs
    if pad:
        def zf(a, val=0.0):
            return torch.cat([a, a.new_full((b, pad) + a.shape[2:], val)],
                             dim=1)
        q, k, v = zf(q), zf(k), zf(v)
        i_pre = zf(i_pre, NEG)          # padded tokens contribute nothing
        f_pre = zf(f_pre, 30.0)         # ~no decay through the padding
    nc = q.shape[1] // qs
    scale = 1.0 / math.sqrt(d)

    def resh(a):                        # (B, nc, H, Q, ...)
        return a.reshape(b, nc, qs, h, *a.shape[3:]).movedim(3, 2)

    qc, kc, vc = resh(q).float(), resh(k).float(), resh(v).float()
    ic = resh(i_pre).float()                            # (B, nc, H, Q)
    bcum = F.logsigmoid(resh(f_pre).float()).cumsum(-1)  # within-chunk

    if state is None:
        C = q.new_zeros((b, h, d, d), dtype=torch.float32)
        n = q.new_zeros((b, h, d), dtype=torch.float32)
        m = q.new_full((b, h), NEG, dtype=torch.float32)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones(qs, qs, dtype=torch.bool, device=q.device))

    outs = []
    for c in range(nc):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]       # (B, H, Q, D)
        bb, ii = bcum[:, c], ic[:, c]                   # (B, H, Q)
        # Intra-chunk log weights D_ij = b_i - b_j + i_j (j <= i).
        dlog = bb[..., :, None] - bb[..., None, :] + ii[..., None, :]
        dlog = dlog.masked_fill(~tri, NEG)
        # Inter-chunk log weight of token i: b_i + m_prev.
        inter_log = bb + m[..., None]
        m_new = torch.maximum(dlog.amax(-1), inter_log)
        m_new = torch.maximum(m_new, -m_new * 0 - 50.0)  # floor

        sc = (qq @ kk.transpose(-1, -2)) * scale
        w = torch.exp(dlog - m_new[..., None]) * sc     # (B, H, Q, Q)
        num = w @ vv
        den = w.sum(-1)
        inter_w = torch.exp(inter_log - m_new)
        q32 = qq * scale
        num = num + (q32 @ C) * inter_w[..., None]
        den = den + (q32 @ n[..., None])[..., 0] * inter_w
        outs.append(num / torch.maximum(den.abs(),
                                        torch.exp(-m_new))[..., None])

        # The state at the chunk's end.
        btot = bb[..., -1:]                             # (B, H, 1)
        m_end = torch.maximum(btot[..., 0] + m, (btot - bb + ii).amax(-1))
        decay = torch.exp(btot[..., 0] + m - m_end)     # (B, H)
        kw = torch.exp(btot - bb + ii - m_end[..., None])  # (B, H, Q)
        kws = kk * kw[..., None]
        C = C * decay[..., None, None] + kws.transpose(-1, -2) @ vv
        n = n * decay[..., None] + kws.sum(-2)
        m = m_end
    hs = torch.stack(outs, 1)                           # (B, nc, H, Q, D)
    out = hs.movedim(2, 3).reshape(b, nc * qs, h, d)[:, :s]
    return out.to(q.dtype), (C, n, m)


def mlstm_step(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,    # (B, H)
    f_pre: torch.Tensor,    # (B, H)
    state: State,
) -> Tuple[torch.Tensor, State]:
    """One token of the mLSTM recurrence; returns ``(h (B, H, D), (C, n,
    m))``."""
    C, n, m = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    logf = F.logsigmoid(f_pre.float())
    i32 = i_pre.float()
    m_new = torch.maximum(logf + m, i32)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(i32 - m_new)
    k32, v32 = k.float(), v.float()
    C_new = C * fw[..., None, None] + iw[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])
    n_new = n * fw[..., None] + iw[..., None] * k32
    q32 = q.float() * scale
    num = (q32[..., None, :] @ C_new)[..., 0, :]
    den = (q32 * n_new).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM cell (sequential; scalar memory + recurrent gate mixing)
# ---------------------------------------------------------------------------


def slstm_scan(
    gx: torch.Tensor,       # (B, S, H, 4, D) gate pre-activations from input
    R: torch.Tensor,        # (H, D, 4, D) block-diagonal recurrent weights
    state: State,           # (c, n, h, m): each (B, H, D) float32
) -> Tuple[torch.Tensor, State]:
    """The sLSTM recurrence, one token at a time.  Returns ``(h (B, S, H,
    D) float32, (c, n, h, m))``."""
    c, n, hprev, m = state
    r32 = R.float()
    g_all = gx.float()
    hs = []
    for t in range(gx.shape[1]):
        g = g_all[:, t] + torch.einsum("bhd,hdge->bhge", hprev, r32)
        z_pre, i_pre, f_pre, o_pre = g.unbind(2)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        fw = torch.exp(logf + m - m_new)
        iw = torch.exp(i_pre - m_new)
        c = fw * c + iw * torch.tanh(z_pre)
        n = fw * n + iw
        hprev = torch.sigmoid(o_pre) * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, 1), (c, n, hprev, m)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def mlstm_param_specs(cfg, layers: int = 0) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    di = _round128(x.mlstm_proj_factor * d)
    h = cfg.n_heads
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "w_up": ParamSpec(ls + (d, 2 * di), la + ("embed", "mlp")),
        "conv_w": ParamSpec(ls + (x.conv_width, di), la + (None, "mlp")),
        "conv_b": ParamSpec(ls + (di,), la + ("mlp",), init="zeros"),
        "wq": ParamSpec(ls + (di, di), la + ("embed", "heads")),
        "wk": ParamSpec(ls + (di, di), la + ("embed", "heads")),
        "wv": ParamSpec(ls + (di, di), la + ("embed", "heads")),
        "wif": ParamSpec(ls + (di, 2 * h), la + ("mlp", None)),
        "out_norm": ParamSpec(ls + (di,), la + ("mlp",), init="ones"),
        "w_down": ParamSpec(ls + (di, d), la + ("mlp", "embed"),
                            scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers))),
    }


def mlstm_block(
    params: dict,
    hidden: torch.Tensor,           # (B, S, d)
    cfg,
    cache: Optional[dict] = None,   # {"conv", "C", "n", "m"}
    chunk: int = 256,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The mLSTM block: up-projection, causal conv, q/k/v and gates, the
    cell (``mlstm_step`` for one token with a cache, else chunkwise from
    the cache's state), the output norm, the z gate and the
    down-projection.  Returns ``(out, new_cache)`` (None without a
    cache)."""
    b, s, d = hidden.shape
    di = _round128(cfg.xlstm.mlstm_proj_factor * d)
    h = cfg.n_heads
    dh = di // h

    up = hidden @ params["w_up"].to(hidden.dtype)
    xm, z = up.chunk(2, dim=-1)
    xc, new_conv = causal_conv1d(xm, params["conv_w"], params["conv_b"],
                                 cache["conv"] if cache is not None
                                 else None)
    q = (xc @ params["wq"].to(xc.dtype)).reshape(b, s, h, dh)
    k = (xc @ params["wk"].to(xc.dtype)).reshape(b, s, h, dh)
    v = (xm @ params["wv"].to(xm.dtype)).reshape(b, s, h, dh)
    i_pre, f_pre = (xm @ params["wif"].to(xm.dtype)).chunk(2, dim=-1)

    new_cache = None
    if cache is not None and s == 1:
        hout, (C, n, m) = mlstm_step(
            q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0],
            (cache["C"], cache["n"], cache["m"]))
        hout = hout[:, None]
        new_cache = {"conv": new_conv, "C": C, "n": n, "m": m}
    else:
        state = None if cache is None else (cache["C"], cache["n"],
                                            cache["m"])
        hout, (C, n, m) = mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk,
                                          state)
        if cache is not None:
            new_cache = {"conv": new_conv, "C": C, "n": n, "m": m}

    hout = rms_norm(hout.reshape(b, s, di), params["out_norm"], cfg.norm_eps)
    out = (hout * F.silu(z)) @ params["w_down"].to(hout.dtype)
    return out, new_cache


def slstm_param_specs(cfg, layers: int = 0) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dff = _round128(x.slstm_proj_factor * d)
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "w_gates": ParamSpec(ls + (d, 4 * d), la + ("embed", "mlp")),
        "r_gates": ParamSpec(ls + (h, dh, 4, dh),
                             la + (None, None, None, None), scale=0.5),
        "out_norm": ParamSpec(ls + (d,), la + ("embed",), init="ones"),
        "w_up_g": ParamSpec(ls + (d, dff), la + ("embed", "mlp")),
        "w_up_v": ParamSpec(ls + (d, dff), la + ("embed", "mlp")),
        "w_down": ParamSpec(ls + (dff, d), la + ("mlp", "embed"),
                            scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers))),
    }


def slstm_block(
    params: dict,
    hidden: torch.Tensor,           # (B, S, d)
    cfg,
    cache: Optional[dict] = None,   # {"c", "n", "h", "m"}, each (B, H, dh)
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The sLSTM block: gate projection, the recurrence from the cache's
    state (zeros, ``m`` at ``NEG``, without one), the output norm and the
    gated-GELU up/down projection.  Returns ``(out, new_cache)``."""
    b, s, d = hidden.shape
    h = cfg.n_heads
    dh = d // h
    gx = (hidden @ params["w_gates"].to(hidden.dtype)).reshape(
        b, s, 4, h, dh).movedim(2, 3)                   # (B, S, H, 4, dh)
    if cache is not None:
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zero = hidden.new_zeros((b, h, dh), dtype=torch.float32)
        state = (zero, zero, zero, torch.full_like(zero, NEG))
    hs, (c, n, hstate, m) = slstm_scan(gx, params["r_gates"], state)
    new_cache = None
    if cache is not None:
        new_cache = {"c": c, "n": n, "h": hstate, "m": m}
    hs = rms_norm(hs.to(hidden.dtype).reshape(b, s, d), params["out_norm"],
                  cfg.norm_eps)
    up = F.gelu(hs @ params["w_up_g"].to(hs.dtype), approximate="tanh") * (
        hs @ params["w_up_v"].to(hs.dtype))
    return up @ params["w_down"].to(up.dtype), new_cache
