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
from torch.distributed.tensor import DTensor, Shard

from repro_torch.dist.sharding import (active_rule, constrain,
                                       local_rows_heads, reduce_grads,
                                       rows_heads_roles, split_heads,
                                       sum_partials)
from repro_torch.models.layers import column_parallel, rms_norm, \
    row_parallel
from repro_torch.models.mamba2 import causal_conv1d
from repro_torch.models.params import ParamSpec
from repro_torch.roofline.ops import loop

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
    group=None,
) -> Tuple[torch.Tensor, State]:
    """Stabilised chunkwise mLSTM.  Returns ``(h (B, S, H, D), (C, n, m))``
    with ``C`` (B, H, D, D), ``n`` (B, H, D) and ``m`` (B, H) in
    float32.

    ``group`` (a ``(mesh, dim)``) is the mesh dim that splits the key dim
    (``q``'s, ``k``'s, ``C``'s dim 2 and ``n``'s): this rank's ``q``,
    ``k``, ``C`` and ``n`` hold their slices of it, ``v``, the gates and
    ``m`` are whole.  The sums over the key dim -- the scores, ``q C``
    and ``q n`` -- are then partial, summed over ``group`` once a chunk
    (``sum_partials``); the state update is local, and the gradients of
    the whole tensors it reads are summed in the backward
    (``reduce_grads``).  ``h`` comes out whole."""
    b, s, h, dk = q.shape
    d = v.shape[-1]                     # the head dim (dk is a slice of it)
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
        C = q.new_zeros((b, h, dk, d), dtype=torch.float32)
        n = q.new_zeros((b, h, dk), dtype=torch.float32)
        m = q.new_full((b, h), NEG, dtype=torch.float32)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones(qs, qs, dtype=torch.bool, device=q.device))

    def chunk_step(c, qc, kc, vc, bcum, ic, C, n, m):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]       # (B, H, Q, D)
        bb, ii = bcum[:, c], ic[:, c]                   # (B, H, Q)
        # Intra-chunk log weights D_ij = b_i - b_j + i_j (j <= i).
        dlog = bb[..., :, None] - bb[..., None, :] + ii[..., None, :]
        dlog = dlog.masked_fill(~tri, NEG)
        # Inter-chunk log weight of token i: b_i + m_prev.
        inter_log = bb + m[..., None]
        m_new = torch.maximum(dlog.amax(-1), inter_log)
        m_new = torch.maximum(m_new, -m_new * 0 - 50.0)  # floor
        q32 = qq * scale
        # The products that contract the key dim.
        sc, qC, qn = sum_partials(group, (qq @ kk.transpose(-1, -2)) * scale,
                                  q32 @ C, (q32 @ n[..., None])[..., 0])
        w = torch.exp(dlog - m_new[..., None]) * sc     # (B, H, Q, Q)
        num = w @ vv
        den = w.sum(-1)
        inter_w = torch.exp(inter_log - m_new)
        num = num + qC * inter_w[..., None]
        den = den + qn * inter_w
        out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
        # The state at the chunk's end.
        btot = bb[..., -1:]                             # (B, H, 1)
        m_end = torch.maximum(btot[..., 0] + m, (btot - bb + ii).amax(-1))
        decay = torch.exp(btot[..., 0] + m - m_end)     # (B, H)
        kw = torch.exp(btot - bb + ii - m_end[..., None])  # (B, H, Q)
        decay, kw, vk = reduce_grads(group, decay, kw, vv)
        kws = kk * kw[..., None]
        C = C * decay[..., None, None] + kws.transpose(-1, -2) @ vk
        n = n * decay[..., None] + kws.sum(-2)
        return out, C, n, m_end

    # The chunk loop runs through ``roofline.ops.loop``, which a dry
    # run's trace of a long prompt samples.
    outs, (C, n, m) = loop(nc, chunk_step, (qc, kc, vc, bcum, ic), (C, n, m))
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
    group=None,
) -> Tuple[torch.Tensor, State]:
    """One token of the mLSTM recurrence; returns ``(h (B, H, D), (C, n,
    m))``.  ``group`` splits the key dim as in ``mlstm_chunkwise``: the
    update is local, ``q C`` and ``q n`` are summed over it once."""
    C, n, m = state
    scale = 1.0 / math.sqrt(v.shape[-1])
    logf = F.logsigmoid(f_pre.float())
    i32 = i_pre.float()
    m_new = torch.maximum(logf + m, i32)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(i32 - m_new)
    k32, v32 = k.float(), v.float()
    fw, iw, v32 = reduce_grads(group, fw, iw, v32)
    C_new = C * fw[..., None, None] + iw[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])
    n_new = n * fw[..., None] + iw[..., None] * k32
    q32 = q.float() * scale
    num, den = sum_partials(group, (q32[..., None, :] @ C_new)[..., 0, :],
                            (q32 * n_new).sum(-1))
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

    def token_step(t, g_all, r32, c, n, hprev, m):
        g = g_all[:, t] + torch.einsum("bhd,hdge->bhge", hprev, r32)
        z_pre, i_pre, f_pre, o_pre = g.unbind(2)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        fw = torch.exp(logf + m - m_new)
        iw = torch.exp(i_pre - m_new)
        c = fw * c + iw * torch.tanh(z_pre)
        n = fw * n + iw
        hprev = torch.sigmoid(o_pre) * c / n.clamp_min(1e-6)
        return hprev, c, n, hprev, m_new

    # The token loop runs through ``roofline.ops.loop``, which a dry
    # run's trace of a long prompt samples.
    hs, (c, n, hprev, m) = loop(gx.shape[1], token_step, (g_all, r32),
                                (c, n, hprev, m))
    return torch.stack(hs, 1), (c, n, hprev, m)


def on_rows(fn, *args, n_out: int, shared=()):
    """``fn(*args)`` for the sLSTM's recurrence, whose work is independent
    along the batch rows (dim 0 of every argument but those ``shared``
    names by position, the recurrent weights; an argument may be None),
    returning ``n_out`` tensors with their rows on dim 0.  On a mesh each
    rank runs it on its own rows, as the first argument's rows shard over
    the data axes, with every other dim gathered whole
    (``dist.sharding.local_rows_heads``): every token mixes a head's whole
    hidden state, and DTensor has no rule for its ``logsigmoid``.  Off a
    mesh, ``fn(*args)``.  (The mLSTM's cell runs on its state's shards:
    ``mlstm_on_shards``.)"""
    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args)
    return local_rows_heads(
        fn, [(a, None if i in shared else 0, None)
             for i, a in enumerate(args)], [(0, None)] * n_out,
        tuple("row" if r == "row" else None
              for r in rows_heads_roles(lead, 0, None)))


def _cell_split(q: DTensor, C, heads: int, head_dim: int):
    """How the mLSTM cell splits on ``q``'s mesh: ``(roles, group)``,
    ``local_rows_heads``' role of each mesh dim ("head" on the dims that
    split the state's heads or its key dim) and the ``(mesh, dim)`` that
    splits the key dim (None where none does).  As the cache's ``C`` is
    placed, where there is one: rows on its dim 0, heads on 1, the key dim
    on 2.  Without one, the rows as ``q``'s shard, and the heads or the
    key dim over the mesh axes the active rules give "state_heads" or
    "state_inner", where they divide.  The key dim splits over at most
    one mesh dim, and not beside split heads."""
    mesh = q.device_mesh
    if isinstance(C, DTensor):
        roles = list(rows_heads_roles(C, 0, 1))
        inner = [i for i, p in enumerate(C.placements)
                 if isinstance(p, Shard) and p.dim == 2]
    else:
        def axes(rule):
            return (rule,) if isinstance(rule, str) else tuple(rule or ())

        on_heads = axes(active_rule("state_heads"))
        on_inner = axes(active_rule("state_inner"))
        roles, inner = [], []
        for i, (name, p) in enumerate(zip(mesh.mesh_dim_names,
                                          q.placements)):
            size = mesh.size(i)
            if isinstance(p, Shard) and p.dim == 0:
                roles.append("row")
            elif size > 1 and name in on_heads and heads % size == 0:
                roles.append("head")
            else:
                roles.append(None)
                if size > 1 and name in on_inner and head_dim % size == 0:
                    inner.append(i)
    if len(inner) != 1 or "head" in roles:
        return tuple(roles), None
    roles[inner[0]] = "head"
    return tuple(roles), (mesh, inner[0])


def mlstm_on_shards(cell, gates, state, step: bool, heads: int,
                    head_dim: int):
    """``cell(group, *gates, *state)`` -> ``(h (B, S, heads * head_dim),
    C, n, m)``, the mLSTM cell with ``gates`` ``(q, k, v, i_pre, f_pre)``
    (the step form's without their token dim) and ``state`` ``(C, n,
    m)`` (Nones without a cache).  Off a mesh, ``cell(None, ...)``.  On a
    mesh each rank runs the cell on its shards of the state, as the
    reference's rules place it, and nothing of the state is gathered
    (``dist.sharding.local_rows_heads``, ``_cell_split``):

      * the batch rows, as ``q``'s (or the cache's) rows shard;
      * where the heads fill "model" ("state_heads"), its heads: ``q``,
        ``k``, ``v``, the gates, ``C``, ``n`` and ``m`` by head; no
        collective runs in the cell, and ``h`` leaves sharded as its
        heads' columns, into the output norm and the row-parallel
        down-projection;
      * where the rules split the state's key dim ("state_inner"), its
        key dim: ``q``, ``k``, ``C`` and ``n`` hold their slices, ``v``,
        the gates and ``m`` are whole, and the cell sums its partial
        products over that mesh dim (``group``, ``mlstm_chunkwise``);
        ``h`` leaves whole.
    """
    if not isinstance(gates[0], DTensor):
        return cell(None, *gates, *state)
    roles, group = _cell_split(gates[0], state[0], heads, head_dim)
    t = 1 if step else 2            # the head dim of the gates
    qk = t + 1 if group else t      # q's and k's split dim
    vg = None if group else t       # v's and the gates'
    cn = 2 if group else 1          # C's and n's
    m = None if group else 1        # m's
    args = [(gates[0], 0, qk), (gates[1], 0, qk), (gates[2], 0, vg),
            (gates[3], 0, vg), (gates[4], 0, vg), (state[0], 0, cn),
            (state[1], 0, cn), (state[2], 0, m)]
    outs = [(0, None if group else 2, heads * head_dim), (0, cn), (0, cn),
            (0, m)]
    return local_rows_heads(lambda *a: cell(group, *a), args, outs, roles,
                            partial=group is None)


def _up_proj(x: torch.Tensor, w: torch.Tensor):
    """``(x @ w).chunk(2, -1)``: the cell's input and the output gate.
    The halves do not split as "model" splits ``w``'s columns, so on a
    mesh one of the two is gathered, whichever is smaller: ``w``, where
    this rank has more tokens than ``w`` has rows (training), each half
    then a column-parallel product of its own half of ``w`` on local
    shards (``layers.column_parallel``); else the product, which DTensor
    gathers whole to split it (a decode step's few tokens) -- where it
    would also make ``w``'s gradient whole on every rank."""
    if not isinstance(x, DTensor) or \
            x.to_local()[..., 0].numel() < w.shape[0]:
        return (x @ w).chunk(2, dim=-1)
    return tuple(column_parallel(lambda x, w: x @ w, x, (half,))
                 for half in w.chunk(2, dim=-1))


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

    xm, z = _up_proj(hidden, params["w_up"].to(hidden.dtype))
    xc, new_conv = causal_conv1d(xm, params["conv_w"], params["conv_b"],
                                 cache["conv"] if cache is not None
                                 else None)
    # On a mesh whose model axis the heads do not fill (4 heads on 16),
    # the flat dim is gathered before the head split (``split_heads``, as
    # the reference's rules drop "heads"); the cell then takes its own
    # slices of the key dim (``mlstm_on_shards``).
    q = split_heads(xc @ params["wq"].to(xc.dtype), h, dh, "state_heads")
    k = split_heads(xc @ params["wk"].to(xc.dtype), h, dh, "state_heads")
    v = split_heads(xm @ params["wv"].to(xm.dtype), h, dh, "state_heads")
    i_pre, f_pre = (xm @ params["wif"].to(xm.dtype)).chunk(2, dim=-1)

    step = cache is not None and s == 1

    def cell(group, q, k, v, i_pre, f_pre, C, n, m):
        # The heads come back flattened (B, S, H * D) -- on a mesh, this
        # rank's heads: a gradient sharded finer than the heads could not
        # be viewed back into them.
        state = None if C is None else (C, n, m)
        if step:
            h_out, state = mlstm_step(q, k, v, i_pre, f_pre, state, group)
        else:
            h_out, state = mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk,
                                           state, group)
        return (h_out.reshape(h_out.shape[0], s, -1),) + state

    gates = (q, k, v, i_pre, f_pre)
    if step:
        gates = tuple(a[:, 0] for a in gates)
    state = (None,) * 3 if cache is None else (cache["C"], cache["n"],
                                               cache["m"])
    hout, C, n, m = mlstm_on_shards(cell, gates, state, step, h, dh)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "C": C, "n": n, "m": m}

    hout = rms_norm(hout, params["out_norm"], cfg.norm_eps)
    # Row-parallel on local shards (``layers.row_parallel``), as the
    # sLSTM block's down-projection below: split heads leave the cell
    # sharded as its columns are.
    out = row_parallel(hout * F.silu(z), params["w_down"].to(hout.dtype))
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
    # The recurrence takes its heads whole on a mesh (below), so the gate
    # pre-activations are gathered over "model" before the gate split: a
    # model axis wider than the 4 gates cannot split them while sharded.
    gx = constrain(hidden @ params["w_gates"].to(hidden.dtype),
                   ("batch", None, None))
    gx = gx.reshape(b, s, 4, h, dh).movedim(2, 3)       # (B, S, H, 4, dh)
    if cache is not None:
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zero = hidden.new_zeros((b, h, dh), dtype=torch.float32)
        state = (zero, zero, zero, torch.full_like(zero, NEG))
    def cell(gx, r, *state):
        hs, state = slstm_scan(gx, r, state)
        return (hs,) + state

    hs, c, n, hstate, m = on_rows(cell, gx, params["r_gates"], *state,
                                  n_out=5, shared=(1,))
    new_cache = None
    if cache is not None:
        new_cache = {"c": c, "n": n, "h": hstate, "m": m}
    hs = hs.to(hidden.dtype).reshape(b, s, d)

    def up_proj(hs, wg, wv, norm):
        hs = rms_norm(hs, norm, cfg.norm_eps)
        return F.gelu(hs @ wg, approximate="tanh") * (hs @ wv)

    # On a mesh the norm, the gated up-projection and the down-projection
    # run on local shards (``layers.column_parallel``, ``row_parallel``):
    # DTensor propagates neither the weight gradients' products over the
    # strided token shards a pipelined backward brings nor a norm's
    # gradient sharded finer than the heads the recurrence splits.
    up = column_parallel(up_proj, hs, (params["w_up_g"].to(hs.dtype),
                                       params["w_up_v"].to(hs.dtype)),
                         (params["out_norm"],))
    return row_parallel(up, params["w_down"].to(up.dtype)), new_cache
