"""Transformer layers, ported from ``repro.models.layers``: norms, RoPE
and Qwen2-VL's multimodal RoPE, SwiGLU, embeddings, the LM head, the two
paged attention blocks the paged engine runs, and the unpaged attention
(``attn_mask``, ``full_attention``, ``blockwise_attention``,
``attention_op``) with the cached ``attention_block`` the cohort engine,
the enc-dec encoder and cross-attention run.

The JAX package's tensor-parallel projections (``tp_matmul`` /
``fused_column_matmul``) are plain ``torch.matmul`` here: the port runs on
one card, and the JAX package leaves these products to XLA, outside any
Pallas kernel.  Attention against the page pool goes through
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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


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
    g = x @ params["wg"].to(x.dtype)
    u = x @ params["wi"].to(x.dtype)
    return (F.silu(g) * u) @ params["wo"].to(x.dtype)


def embed_tokens(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embedding"].to(dtype)[tokens.long()]


def lm_logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
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
    outs = []
    for i in range(nq):
        qi = qp[:, i * block_q:(i + 1) * block_q]
        qpos_i = qpos[i * block_q:(i + 1) * block_q]
        m = q.new_full((b, h, block_q), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, h, block_q), dtype=torch.float32)
        acc = q.new_zeros((b, h, block_q, d), dtype=torch.float32)
        for j in range(nk):
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
            m = m_new
        out = acc / l[..., None].clamp_min(1e-30)
        outs.append(out.movedim(1, 2).to(q.dtype))          # (B, bq, H, D)
    return torch.cat(outs, dim=1)[:, :sq]


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, cfg,
                 causal: bool = True,
                 kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's dispatch on one card: K/V repeated to the query
    heads, then ``full_attention`` when a valid length is given, the keys
    are at most ``cfg.attn_blockwise_threshold`` or the query is one
    token; otherwise ``blockwise_attention`` at the blocks the port's
    decomposer plans for the shape (``core.autotile.plan_attention``, at
    2-byte elements as the reference plans them)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    sk = k.shape[1]
    if (kv_len is not None or sk <= cfg.attn_blockwise_threshold
            or q.shape[1] == 1):
        return full_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=cfg.sliding_window, kv_len=kv_len)
    from repro_torch.core.autotile import plan_attention

    plan = plan_attention(q.shape[1], sk, q.shape[-1], dtype_bytes=2)
    return blockwise_attention(q, k, v, q_pos, k_pos,
                               block_q=int(plan.block_q),
                               block_kv=int(plan.block_kv), causal=causal,
                               window=cfg.sliding_window)


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
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
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
            ck.copy_(tail_k)
            cv.copy_(tail_v)
        else:
            ck[:, :s] = k
            cv[:, :s] = v
        cache["len"] += s
    out = attention_op(q, k, v, q_pos, k_pos, cfg, causal=causal,
                       kv_len=kv_len)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Paged attention blocks
# ---------------------------------------------------------------------------


def _qkv(params: dict, x: torch.Tensor, cfg):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd),
            v.reshape(b, s, kv, hd))


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
    pos = pos.long()
    page_slot = pos // t
    n_logical = table.shape[1]
    page_ids = table.long().gather(
        1, page_slot.clamp(max=n_logical - 1)[:, None])[:, 0]
    # A position past the table (a stalled slot riding through the batch)
    # must land on the null page, not clamp onto the slot's last live page.
    page_ids = torch.where(page_slot < n_logical, page_ids, 0)
    off = pos % t
    k_pool[layer].index_put_((page_ids, off), k[:, 0].to(k_pool.dtype))
    v_pool[layer].index_put_((page_ids, off), v[:, 0].to(v_pool.dtype))

    out = paged_attention(q[:, 0].contiguous(), k_pool[layer], v_pool[layer],
                          table, (pos + 1).to(torch.int32),
                          window=cfg.sliding_window or 0, page_tokens=t)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype)


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
    positions = positions.long()
    page_slot = positions // t
    n_logical = table_row.shape[0]
    page_ids = table_row.long()[page_slot.clamp(max=n_logical - 1)]
    page_ids = torch.where(page_slot < n_logical, page_ids, 0)
    off = positions % t
    k_pool[layer].index_put_((page_ids, off), k[0].to(k_pool.dtype))
    v_pool[layer].index_put_((page_ids, off), v[0].to(v_pool.dtype))

    # Each chunk token is a decode row over the same table with its own
    # causal length: the kernel's per-row length mask does the intra-chunk
    # causal masking.
    table = table_row[None, :].expand(c, n_logical).contiguous()
    out = paged_attention(q[0].contiguous(), k_pool[layer], v_pool[layer],
                          table, (positions + 1).to(torch.int32),
                          window=cfg.sliding_window or 0, page_tokens=t)
    return out.reshape(b, c, -1) @ params["wo"].to(x.dtype)
