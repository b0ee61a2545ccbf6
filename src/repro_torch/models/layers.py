"""Transformer layers, ported from ``repro.models.layers``: norms, RoPE
and Qwen2-VL's multimodal RoPE, SwiGLU, embeddings, the LM head, the two
paged attention blocks the paged engine runs, and the unpaged attention
(``attn_mask``, ``full_attention``, ``blockwise_attention``,
``attention_op``) with the cached ``attention_block`` the cohort engine,
the enc-dec encoder, cross-attention and the training forward run, and
the training loss (``cross_entropy_loss``).

Every tensor-parallel projection (attention q/k/v/o, the SwiGLU FFN, the
LM head) goes through ``tp_matmul``, which routes to ``dist.overlap``'s
ring/serpentine collective matmuls when the active sharding rules request
them and is a plain ``torch.matmul`` otherwise -- on one device, or on a
mesh under gspmd rules, where DTensor's sharding propagation places the
collectives.  Projections that share an input (q/k/v, the SwiGLU wg/wi)
go through ``fused_column_matmul``, so ``x`` streams around the ring once
a block, not once a projection.  The ``constrain`` sites are the
reference's: the identity off a mesh.  Attention against the page pool goes through
``kernels.paged_attention`` -- the hand-written CUDA kernel on a card, its
plain PyTorch version on the CPU.

Unlike the pure JAX functions, the paged blocks write the new K/V into the
page pool IN PLACE (``index_put_``), and the cached ``attention_block``
writes it into its contiguous cache buffer in place (and advances the
cache's host-side ``len``); they return only the attention output.  The
unpaged attention is plain torch ops (einsum, softmax), as the reference's
is jnp outside any Pallas kernel: its blockwise form streams KV blocks
with a running softmax and is not routed to the port's flash kernel, as
the reference's model never calls its own.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.overlap import overlap_matmul, overlap_matmul_fused
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.sharding import (active_overlap, active_rule, constrain,
                                       from_local_like, like_heads_of,
                                       local_extent, local_rows_heads,
                                       rows_heads_roles, split_heads,
                                       take_rows, write_slice)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.params import ParamSpec
from repro_torch.roofline.ops import loop

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Tensor-parallel projection dispatch
# ---------------------------------------------------------------------------


class _RowParallelMatmul(torch.autograd.Function):
    """Megatron's row-parallel pair on local shards: the forward is the
    local product ``x_local @ w_local`` (the contraction dim split over
    "model"), all-reduced over "model"; the backward takes ``dY`` whole
    (the caller's ``DTensor.from_local`` has reduced it to ``Replicate``
    over "model", one all-reduce where it arrived as a partial sum) and
    computes ``dX_local = dY @ w_localᵀ`` and ``dW_local = x_localᵀ @ dY``
    on the local shards -- nothing is gathered at full width."""

    @staticmethod
    def forward(ctx, x, w, group):
        import torch.distributed._functional_collectives as funcol

        ctx.save_for_backward(x, w)
        y = funcol.all_reduce(x @ w, "sum", group)
        return funcol.wait_tensor(y)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).T @ dy.reshape(-1, dy.shape[-1])
        return dx, dw, None


def _row_parallel(x: DTensor, w: DTensor) -> Optional[torch.Tensor]:
    """``x @ w`` for a row-parallel weight on a mesh, through
    ``_RowParallelMatmul``: ``x``'s last dim and ``w``'s first shard over
    "model"; ``x`` keeps its batch-row shards and ``w`` replicates over
    the other mesh dims (its gradient a partial sum over those that shard
    ``x``'s rows).  The result is replicated over "model" and keeps
    ``x``'s row shards.  None where it does not apply (no "model" axis of
    size > 1, a contraction dim it does not divide, or a shard of another
    dim of ``x``)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None
    m = names.index("model")
    k = x.dim() - 1
    if mesh.size(m) <= 1 or w.shape[0] % mesh.size(m) \
            or x.shape[k] != w.shape[0]:
        return None
    x_place, w_place, w_grad, y_place = [], [], [], []
    for i, p in enumerate(x.placements):
        if i == m:
            x_place.append(Shard(k))
            w_place.append(Shard(0))
            w_grad.append(Shard(0))
            y_place.append(Replicate())
        elif isinstance(p, Shard) and p.dim < k:
            if p.dim != 0:
                return None
            x_place.append(p)
            w_place.append(Replicate())
            w_grad.append(Partial())
            y_place.append(p)
        else:
            x_place.append(Replicate())
            w_place.append(Replicate())
            w_grad.append(Replicate())
            y_place.append(Replicate())
    if tuple(x.placements) != tuple(x_place):
        x = x.redistribute(mesh, x_place)
    if tuple(w.placements) != tuple(w_place):
        w = w.redistribute(mesh, w_place)
    y = _RowParallelMatmul.apply(x.to_local(), w.to_local(
        grad_placements=w_grad), (mesh, m))
    return from_local_like(y, mesh, tuple(y_place),
                           tuple(x.shape[:-1]) + (w.shape[1],))


def tp_matmul(x: torch.Tensor, w: torch.Tensor, parallel: str) -> torch.Tensor:
    """Projection ``y = x @ w`` over the last dim: through ``dist.overlap``'s
    ring kernels when the active rules request ring/serpentine collectives
    and the shapes divide the ring, a plain product otherwise -- on a mesh
    under gspmd rules a row-parallel product runs on local shards
    (``_RowParallelMatmul``), the rest through DTensor's propagation.
    ``parallel`` is the weight's TP orientation: "column" (n sharded ->
    all-gather ring) or "row" (k sharded -> reduce-scatter ring)."""
    if active_overlap() is not None:
        y = overlap_matmul(x, w, parallel)
        if y is not None:
            return y
    return row_parallel(x, w) if parallel == "row" else x @ w


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight (its rows shard over "model"):
    on a mesh through ``_RowParallelMatmul`` on local shards where it
    applies, a plain product otherwise.  The Mamba2 mixer's output
    projection and the xLSTM blocks' down-projections take it directly
    (they have no ring route)."""
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        y = _row_parallel(x, w)
        if y is not None:
            return y
    return x @ w


def column_parallel(fn, x: torch.Tensor, ws, shared=()) -> torch.Tensor:
    """``fn(x, *ws, *shared)`` where each of ``ws`` is a column-parallel
    weight (its last dim shards over "model") and ``fn`` maps ``x``
    ``(B, ..., k)`` to ``(B, ..., n)`` through them, column by column (the
    products and what is elementwise after them; ``shared`` are
    replicated operands such as a norm's scale).  On a mesh it runs on
    local shards (``dist.sharding.local_rows_heads``): ``x`` keeps its
    batch rows' shards and replicates over "model", the result shards its
    last dim over "model" as the weights do.  The products' backward then
    takes ``dY`` in that placement and reduces ``dX`` once over "model":
    DTensor's own propagation of the weight gradient's product refuses the
    strided token shards a pipelined backward hands it.  Off a mesh, or
    where "model" does not divide the columns, ``fn`` on the tensors as
    they are."""
    if not isinstance(x, DTensor):
        return fn(x, *ws, *shared)
    mesh = x.device_mesh
    n = ws[0].shape[-1]
    roles = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if name == "model" and mesh.size(i) > 1:
            if n % mesh.size(i):
                return fn(x, *ws, *shared)
            roles.append("head")
        else:
            roles.append("row" if isinstance(p, Shard) and p.dim == 0
                         else None)
    last = x.dim() - 1
    return local_rows_heads(
        fn, [(x, 0, None)] + [(w, None, w.dim() - 1) for w in ws]
        + [(s, None, None) for s in shared], [(0, last)], tuple(roles))


def fused_column_matmul(x: torch.Tensor, ws) -> list:
    """Several column-parallel projections of the same ``x`` through ONE
    all-gather ring (``dist.overlap.make_ag_matmul_fused``); per-weight
    ``tp_matmul`` when the fused ring does not apply."""
    if active_overlap() is None:        # one device, serving, gspmd rules
        return [x @ w for w in ws]
    ys = overlap_matmul_fused(x, tuple(ws))
    if ys is None:
        return [tp_matmul(x, w, "column") for w in ws]
    return ys


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32, returned in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                theta: float = 1e6,
                sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: the ``D/2`` frequency slots of ``x``
    ``(B, S, H, D)`` are split into (temporal, height, width) sections,
    each rotated by its own stream of ``positions`` ``(3, B, S)``.  The
    default sections are Qwen2-VL's (16, 24, 24) of 64 slots, scaled to
    ``D``."""
    d = x.shape[-1]
    if sections is None:
        t = d // 8
        h = (d // 2 - t) // 2
        sections = (t, h, d // 2 - t - h)
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to D/2 = "
                         f"{d // 2}")
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    # The stream that drives each frequency slot: (B, S, D/2).
    pos = torch.cat([positions[i, ..., None].expand(*positions.shape[1:], n)
                     for i, n in enumerate(sections)], dim=-1)
    angles = pos.float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter specs (same paths and shapes as the JAX package)
# ---------------------------------------------------------------------------


def attention_param_specs(cfg, layers: int = 0) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    out_scale = 1.0 / math.sqrt(2 * max(1, cfg.n_layers))
    specs = {
        "wq": ParamSpec(ls + (d, h * hd), la + ("embed", "heads")),
        "wk": ParamSpec(ls + (d, kv * hd), la + ("embed", "heads")),
        "wv": ParamSpec(ls + (d, kv * hd), la + ("embed", "heads")),
        "wo": ParamSpec(ls + (h * hd, d), la + ("heads", "embed"),
                        scale=out_scale),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec(ls + (h * hd,), la + ("heads",), init="zeros")
        specs["bk"] = ParamSpec(ls + (kv * hd,), la + ("heads",), init="zeros")
        specs["bv"] = ParamSpec(ls + (kv * hd,), la + ("heads",), init="zeros")
    return specs


def ffn_param_specs(cfg, d_ff: Optional[int] = None, layers: int = 0) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "wi": ParamSpec(ls + (d, f), la + ("embed", "mlp")),
        "wg": ParamSpec(ls + (d, f), la + ("embed", "mlp")),
        "wo": ParamSpec(ls + (f, d), la + ("mlp", "embed"),
                        scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers))),
    }


def padded_vocab(cfg, mult: int = 32) -> int:
    """The vocab padded to a multiple of ``mult``; pad logits are masked in
    ``lm_logits``."""
    return ((cfg.vocab_size + mult - 1) // mult) * mult


def embed_param_specs(cfg) -> dict:
    v = padded_vocab(cfg)
    specs = {
        "embedding": ParamSpec((v, cfg.d_model), ("vocab", "embed"),
                               init="embed"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, v), ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# FFN, embeddings, LM head
# ---------------------------------------------------------------------------


def swiglu_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    g, u = fused_column_matmul(x, (params["wg"].to(x.dtype),
                                   params["wi"].to(x.dtype)))
    return tp_matmul(F.silu(g) * u, params["wo"].to(x.dtype), "row")


def embed_tokens(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return take_rows(params["embedding"].to(dtype), tokens)


def lm_logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(x.dtype).T
    else:
        logits = tp_matmul(x, params["lm_head"].to(x.dtype), "column")
    if logits.shape[-1] != cfg.vocab_size:   # padded vocab: mask pad slots
        pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


# ---------------------------------------------------------------------------
# Unpaged attention (the cohort engine, the enc-dec encoder and
# cross-attention)
# ---------------------------------------------------------------------------


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV * n_rep, D) by broadcast (GQA)."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
              window: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row attention mask, shaped ``(B | 1, 1, Sq, Sk)``, True where
    attention is allowed.

    ``q_pos`` is ``(Sq,)`` or ``(B, Sq)``, ``k_pos`` ``(Sk,)`` or ``(B,
    Sk)``, and ``kv_len`` (the valid key length) a scalar or ``(B,)``: the
    paged enc-dec decode gives every row its own encoder length.  A
    negative ``k_pos`` always masks."""
    qp = q_pos[..., :, None]                       # (..., Sq, 1)
    kp = k_pos[..., None, :]                       # (..., 1, Sk)
    m = kp >= 0
    if causal or window:
        m = m & (kp <= qp)
        if window:
            m = m & (kp > qp - window)
    else:
        m = m & torch.ones_like(qp, dtype=torch.bool)   # to (.., Sq, Sk)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=kp.device)
        m = m & (kp < kl[..., None, None])
    while m.dim() < 3:
        m = m[None]
    return m[:, None]                              # head axis


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   causal: bool = True, window: int = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over whole (already GQA-repeated) K/V: q ``(B, Sq, H,
    D)``, k and v ``(B, Sk, H, D)``.  The logits are cast to float32 after
    the product and masked with the finite ``NEG_INF``, so a row with no
    valid key softmaxes uniformly (over zero-padded V: zeros), not NaN."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = attn_mask(q_pos, k_pos, causal=causal, window=window,
                     kv_len=kv_len)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        block_q: int, block_kv: int, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Attention over whole (already GQA-repeated) K/V without the ``(Sq,
    Sk)`` logits: ``block_kv`` keys at a time with a running (max, sum,
    acc) softmax, ``block_q`` queries at a time -- the reference's pure-JAX
    flash attention, step for step (q ``(B, Sq, H, D)``, k and v ``(B, Sk,
    H, D)``, positions ``(Sq,)`` and ``(Sk,)``).

    As in the reference, the queries are padded at position -1 and the
    keys at ``2**30`` up to whole blocks; a causal or windowed mask hides
    the padded keys, and without one they take part (zero logits over
    zero values), as the reference's do."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    nq, nk = -(-sq // block_q), -(-sk // block_kv)
    pq, pk = nq * block_q - sq, nk * block_kv - sk
    qp = F.pad(q, (0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    qpos = F.pad(q_pos, (0, pq), value=-1)
    kpos = F.pad(k_pos, (0, pk), value=2 ** 30)

    def kv_block(j, qi, qpos_i, kp, vp, m, l, acc):
        kj = kp[:, j * block_kv:(j + 1) * block_kv]
        vj = vp[:, j * block_kv:(j + 1) * block_kv]
        logits = torch.einsum("bqhd,bkhd->bhqk", qi, kj).float() * scale
        if causal or window:
            kpos_j = kpos[j * block_kv:(j + 1) * block_kv]
            mask = kpos_j[None, :] <= qpos_i[:, None]
            if window:
                mask = mask & (kpos_j[None, :] > qpos_i[:, None] - window)
            logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(qi.dtype), vj).float()
        return None, m_new, l, acc

    def q_block(i, qp, kp, vp):
        qi = qp[:, i * block_q:(i + 1) * block_q]
        qpos_i = qpos[i * block_q:(i + 1) * block_q]
        m = q.new_full((b, h, block_q), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, h, block_q), dtype=torch.float32)
        acc = q.new_zeros((b, h, block_q, d), dtype=torch.float32)
        _, (m, l, acc) = loop(nk, kv_block, (qi, qpos_i, kp, vp),
                              (m, l, acc))
        out = acc / l[..., None].clamp_min(1e-30)
        return (out.movedim(1, 2).to(q.dtype),)            # (B, bq, H, D)

    # The block loops run through ``roofline.ops.loop``, which a dry run's
    # trace of a long prompt samples (three trips a loop, counted for all).
    outs, _ = loop(nq, q_block, (qp, kp, vp), ())
    return torch.cat(outs, dim=1)[:, :sq]


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention without the head-repeated K/V: q ``(B, Sq, H, D)``
    grouped per KV head and contracted directly against k and v ``(B, Sk,
    KV, D)`` (a sequence-sharded cache).  Equal to ``repeat_kv`` +
    ``full_attention``."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    mask = attn_mask(q_pos, k_pos, causal=causal, window=window,
                     kv_len=kv_len)                  # (B|1, 1, Sq, Sk)
    logits = logits.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, cfg,
                 causal: bool = True,
                 kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's dispatch on one card: K/V repeated to the query
    heads, then ``full_attention`` when a valid length is given, the keys
    are at most ``cfg.attn_blockwise_threshold`` or the query is one
    token; otherwise ``blockwise_attention`` at the blocks the port's
    decomposer plans for the shape (``core.autotile.plan_attention``, at
    2-byte elements as the reference plans them).  Under rules that shard
    the KV sequence, a one-token query goes to ``grouped_attention``
    against the sharded K/V instead."""
    if q.shape[1] == 1 and active_rule("kv_seq") is not None:
        # The query's heads replicate: each rank contracts every head with
        # its sequence shard (and a head count the model axis does not
        # divide into KV groups cannot be grouped while sharded).
        q = constrain(q, ("batch", None, None, None))
        k = constrain(k, ("batch", "kv_seq", None, None))
        v = constrain(v, ("batch", "kv_seq", None, None))
        return grouped_attention(q, k, v, q_pos, k_pos, causal=causal,
                                 window=cfg.sliding_window, kv_len=kv_len)
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    # Pin the repeated K/V to the head sharding of Q.
    k = constrain(k, ("batch", None, "heads", None))
    v = constrain(v, ("batch", None, "heads", None))
    sk = k.shape[1]
    # On a mesh each rank attends over its own batch rows and heads (and
    # takes its rows' positions and valid lengths).
    if isinstance(q, DTensor):
        lo, n = local_extent(q, 0)

        def own_rows(t, row_dims):
            if not isinstance(t, torch.Tensor) or t.dim() != row_dims:
                return t
            if isinstance(t, DTensor):
                t = t.full_tensor()
            return t[lo:lo + n]

        q_pos, k_pos = own_rows(q_pos, 2), own_rows(k_pos, 2)
        kv_len = own_rows(kv_len, 1)
    if (kv_len is not None or sk <= cfg.attn_blockwise_threshold
            or q.shape[1] == 1):
        return _on_rows_and_heads(lambda q, k, v: full_attention(
            q, k, v, q_pos, k_pos, causal=causal,
            window=cfg.sliding_window, kv_len=kv_len), q, k, v)
    from repro_torch.core.autotile import plan_attention

    plan = plan_attention(q.shape[1], sk, q.shape[-1], dtype_bytes=2)
    return _on_rows_and_heads(lambda q, k, v: blockwise_attention(
        q, k, v, q_pos, k_pos, block_q=int(plan.block_q),
        block_kv=int(plan.block_kv), causal=causal,
        window=cfg.sliding_window), q, k, v)


def _on_rows_and_heads(fn, q, k, v):
    """``fn(q, k, v)`` -- attention, independent along batch rows and
    heads -- on each rank's rows and heads of DTensors ``(B, S, H, D)``
    placed as ``q`` is (``dist.sharding.local_rows_heads``): DTensor's
    einsum decomposition would flatten two sharded dims, which some torch
    versions refuse.  Off a mesh it is ``fn(q, k, v)``."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    return local_rows_heads(fn, [(q, 0, 2), (k, 0, 2), (v, 0, 2)], [(0, 2)],
                            rows_heads_roles(q, 0, 2))


def attention_block(params: dict, x: torch.Tensor, q_pos: torch.Tensor,
                    cfg, cache: Optional[dict] = None,
                    positions_3d: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """The reference's ``attention_block``: the Q/K/V projections, RoPE at
    ``q_pos`` on q and k (the reference ropes here even in the non-causal
    encoder; M-RoPE at ``positions_3d`` ``(3, B, S)`` instead when
    ``cfg.mrope`` and they are given), attention and the output
    projection.  ``x`` ``(B, S, d)`` -> ``(B, S, d)``.

    Without a cache, attention is within ``x``.  With one (a layer's
    ``{"k", "v": (B, W, KV, D), "len": host counter}``), the new K/V go
    into the buffer IN PLACE and ``len`` advances by ``S``:

      * one token is written at ``len`` (a growable cache, whose keys are
        masked at ``len + 1``) or at ``len mod W`` (a sliding-window ring:
        ``W`` at most the window, so ring slot ``j`` holds position
        ``len - (len - j) mod W``, negative while empty) and attends over
        the whole buffer;
      * a prompt (from an empty cache) attends within itself, then stores
        its last ``W`` tokens -- for a ring rolled by ``(S - W) mod W``,
        so position ``p`` sits at slot ``p mod W`` -- or, shorter than
        ``W``, all of them from slot 0.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if cfg.mrope and positions_3d is not None:
        q = apply_mrope(q, positions_3d, cfg.rope_theta)
        k = apply_mrope(k, positions_3d, cfg.rope_theta)
    else:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    k_pos, kv_len = q_pos, None
    if cache is not None:
        idx = int(cache["len"])
        ck, cv = cache["k"], cache["v"]
        w = ck.shape[1]                              # the buffer's extent
        ring = bool(cfg.sliding_window) and w <= cfg.sliding_window
        if s == 1:
            slot = idx % w if ring else idx
            write_slice(ck, k, 1, slot)
            write_slice(cv, v, 1, slot)
            k, v = ck.to(x.dtype), cv.to(x.dtype)
            j = torch.arange(w, device=x.device)
            if ring:
                k_pos = idx - torch.remainder(idx - j, w)
            else:
                k_pos, kv_len = j, idx + 1
        elif s >= w:
            tail_k, tail_v = k[:, s - w:], v[:, s - w:]
            if ring:
                shift = (s - w) % w
                tail_k = torch.roll(tail_k, shift, dims=1)
                tail_v = torch.roll(tail_v, shift, dims=1)
            write_slice(ck, tail_k, 1, 0)
            write_slice(cv, tail_v, 1, 0)
        else:
            write_slice(ck, k, 1, 0)
            write_slice(cv, v, 1, 0)
        cache["len"] += s
    out = attention_op(q, k, v, q_pos, k_pos, cfg, causal=causal,
                       kv_len=kv_len)
    return tp_matmul(out.reshape(b, s, -1), params["wo"].to(x.dtype), "row")


# ---------------------------------------------------------------------------
# Paged attention blocks
# ---------------------------------------------------------------------------


def _qkv(params: dict, x: torch.Tensor, cfg):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = fused_column_matmul(x, (params["wq"].to(x.dtype),
                                      params["wk"].to(x.dtype),
                                      params["wv"].to(x.dtype)))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (split_heads(q, h, hd, "heads"), split_heads(k, kv, hd, "kv_heads"),
            split_heads(v, kv, hd, "kv_heads"))


def paged_attention_block(
    params: dict,
    x: torch.Tensor,               # (S, 1, d) -- one decode token per slot
    pos: torch.Tensor,             # (S,) per-slot absolute position
    cfg,
    k_pool: torch.Tensor,          # (L, P, T, KV, D) page pool
    v_pool: torch.Tensor,
    layer: int,
    table: torch.Tensor,           # (S, NP) int32 page table
) -> torch.Tensor:
    """Per-slot decode attention against the paged KV pool.

    Each row carries its own absolute position (per-sequence RoPE offset)
    and valid length ``pos + 1``.  The new token's K/V is written IN PLACE
    through the page table (``table[s, pos // T]`` at offset ``pos % T``;
    empty slots carry ``pos == 0`` and a null table row, so their write
    lands on the reserved page 0), then the paged-attention kernel streams
    the slot's pages.  Returns ``(S, 1, d)``.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)     # per-seq rope offset
    k = apply_rope(k, pos[:, None], cfg.rope_theta)

    t = k_pool.shape[2]
    page_ids, off = pool_slots(table, pos, t)
    out = pool_write_attend(q[:, 0], k[:, 0], v[:, 0], k_pool, v_pool, layer,
                            page_ids, off, table,
                            (pos.long() + 1).to(torch.int32),
                            cfg.sliding_window or 0, t)
    return tp_matmul(out.reshape(b, s, -1), params["wo"].to(x.dtype), "row")


def paged_prefill_block(
    params: dict,
    x: torch.Tensor,               # (1, C, d) -- one prompt chunk
    positions: torch.Tensor,       # (C,) absolute positions of the chunk
    cfg,
    k_pool: torch.Tensor,          # (L, P, T, KV, D) page pool
    v_pool: torch.Tensor,
    layer: int,
    table_row: torch.Tensor,       # (NP,) int32 -- ONE slot's page table
) -> torch.Tensor:
    """One prompt chunk's attention, K/V written straight into pool pages.

    The chunk projects q/k/v, ropes at its absolute ``positions``, writes
    K/V IN PLACE through the slot's ``table_row`` (page ``positions // T``
    at offset ``positions % T``), and attends causally over everything
    written so far by treating each chunk token as a decode row of length
    ``position + 1`` in the paged kernel.  Returns ``(1, C, d)``.
    """
    b, c, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)

    t = k_pool.shape[2]
    # Each chunk token is a decode row over the same table with its own
    # causal length: the kernel's per-row length mask does the intra-chunk
    # causal masking.
    table = table_row[None, :].expand(c, table_row.shape[0]).contiguous()
    page_ids, off = pool_slots(table, positions, t)
    out = pool_write_attend(q[0], k[0], v[0], k_pool, v_pool, layer,
                            page_ids, off, table,
                            (positions.long() + 1).to(torch.int32),
                            cfg.sliding_window or 0, t)
    return tp_matmul(out.reshape(b, c, -1), params["wo"].to(x.dtype), "row")


def pool_slots(table: torch.Tensor, positions: torch.Tensor, t: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(page_ids, offsets)`` where each row's new K/V lands: page
    ``table[r, positions[r] // t]`` at offset ``positions[r] % t``.  A
    position past the table (a stalled slot riding through the batch)
    lands on the null page 0, not clamped onto the slot's last live
    page."""
    positions = positions.long()
    page_slot = positions // t
    n_logical = table.shape[1]
    page_ids = table.long().gather(
        1, page_slot.clamp(max=n_logical - 1)[:, None])[:, 0]
    return torch.where(page_slot < n_logical, page_ids, 0), positions % t


def pool_write_attend(q, k, v, k_pool, v_pool, layer: int,
                      page_ids: torch.Tensor, off: torch.Tensor,
                      table: torch.Tensor, lengths: torch.Tensor,
                      window: int, t: int) -> torch.Tensor:
    """Write the rows' new K/V ``(R, KV, D)`` into the pool at ``(page_ids,
    off)`` IN PLACE, then run the paged-attention kernel for the queries
    ``(R, H, D)``; returns ``(R, H, D)``.  ``v`` None: one pool is both K
    and V (MLA's latent; ``v_pool`` is ``k_pool``), written once.

    On a mesh the pool is a DTensor whose KV heads shard over "model"
    when the plan's ``kv_shard > 1`` (replicated over the data axes), and
    everything happens on local shards: K/V, gathered over the data axes
    (every data rank's pool holds every slot's rows) and sharded over
    heads as the pool is, are written into the local pool; the queries
    take the pool's head sharding (contiguous head blocks, so GQA's groups
    stay whole) -- over one KV head, which every query head reads, they
    keep their own -- and their rows' data sharding, and the kernel runs
    on this rank's rows and heads with the table rows and lengths those
    rows own.  The kernel wrapper sees plain tensors only."""
    writes = ((k_pool, k),) if v is None else ((k_pool, k), (v_pool, v))
    if not isinstance(k_pool, DTensor):
        for pool, new in writes:
            pool[layer].index_put_((page_ids, off), new.to(pool.dtype))
        return paged_attention(q.contiguous(), k_pool[layer], v_pool[layer],
                               table, lengths, window=window, page_tokens=t)
    mesh = k_pool.device_mesh
    kv_place = like_heads_of(k, k_pool, 1, 3, row_dim=None)
    for pool, new in writes:
        if tuple(new.placements) != kv_place:
            new = new.redistribute(mesh, kv_place)
        pool.to_local()[layer].index_put_(
            (page_ids, off), new.to_local().to(pool.dtype))
    q_place = like_heads_of(q, k_pool, 1, 3, row_dim=0)
    if k_pool.shape[3] == 1:
        q_place = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 1
                        else w for p, w in zip(q.placements, q_place))
    if tuple(q.placements) != q_place:
        q = q.redistribute(mesh, q_place)
    lo, n = local_extent(q, 0)
    kp, vp = k_pool.to_local(), v_pool.to_local()
    out = paged_attention(q.to_local().contiguous(), kp[layer], vp[layer],
                          table[lo:lo + n].contiguous(), lengths[lo:lo + n],
                          window=window, page_tokens=t)
    return from_local_like(out, mesh, q_place, q.shape)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


class _VocabParallelTerms(torch.autograd.Function):
    """Each token's ``(lse - logit[label], lse**2)`` from this rank's
    vocab shard of the float32 logits ``(..., V_local)``, whose global
    vocab offset is ``lo``: the max, the sum of exponentials and the
    label's logit are each all-reduced over ``group`` (the mesh dim that
    shards the vocab; None where it is whole).  The backward is the local
    softmax times the terms' weights less the local one-hot: nothing of
    full vocab width is made on any rank."""

    @staticmethod
    def forward(ctx, lg, labels, lo, group):
        import torch.distributed._functional_collectives as funcol

        def reduce(t, op):
            if group is None:
                return t
            return funcol.wait_tensor(funcol.all_reduce(t, op, group))

        n = lg.shape[-1]
        m = reduce(lg.amax(dim=-1), "max")
        lse = m + torch.log(reduce(torch.exp(lg - m[..., None]).sum(-1),
                                   "sum"))
        own = (labels >= lo) & (labels < lo + n)
        idx = torch.where(own, labels - lo, 0)
        ll = reduce(torch.where(own, lg.gather(-1, idx[..., None])[..., 0],
                                0.0), "sum")
        ctx.save_for_backward(lg, lse, own, idx)
        return torch.stack([lse - ll, lse.square()], dim=-1)

    @staticmethod
    def backward(ctx, dt):
        lg, lse, own, idx = ctx.saved_tensors
        d_nll, d_sq = dt[..., 0], dt[..., 1]
        grad = torch.exp(lg - lse[..., None]) \
            * (d_nll + 2.0 * lse * d_sq)[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(own, -d_nll, 0.0)[..., None])
        return grad, None, None, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token NLL in float32, plus ``z_loss`` times the mean squared
    log-sum-exp (the reference's control of logit drift).

    On a mesh the logits keep their vocab shard over "model" (as the
    reference's GSPMD keeps them) and each rank computes its own tokens'
    terms from its vocab shard (``_VocabParallelTerms``): the log-sum-exp
    and the label's logit are all-reduced over the vocab's mesh dim, and
    no rank gathers the vocab or holds the global logits' gradient."""
    logits = constrain(logits.float(), ("batch", "seq", "vocab"))
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        v = logits.dim() - 1
        place, group = [], None
        for i, p in enumerate(logits.placements):
            if isinstance(p, Shard) and p.dim == v:
                place.append(p)
                group = (mesh, i)
            elif isinstance(p, Shard) and p.dim < v:
                place.append(p)
            else:
                place.append(Replicate())
        place = tuple(place)
        if tuple(logits.placements) != place:
            logits = logits.redistribute(mesh, place)
        if not isinstance(labels, DTensor):
            labels = DTensor.from_local(labels, mesh,
                                        [Replicate()] * mesh.ndim,
                                        run_check=False)
        lb_place = tuple(p if isinstance(p, Shard) and p.dim < v
                         else Replicate() for p in place)
        if tuple(labels.placements) != lb_place:
            labels = labels.redistribute(mesh, lb_place)
        lo, _ = local_extent(logits, v)
        t = _VocabParallelTerms.apply(
            logits.to_local(grad_placements=place),
            labels.to_local().long(), lo, group)
        t = from_local_like(t, mesh, lb_place, tuple(labels.shape) + (2,))
        loss = t[..., 0].mean()
        if z_loss:
            loss = loss + z_loss * t[..., 1].mean()
        return loss
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss
