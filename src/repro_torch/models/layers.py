"""Transformer layers of the dense GQA family, ported from
``repro.models.layers``: norms, RoPE, SwiGLU, embeddings, the LM head, the
two paged attention blocks the serving engine runs, and the unpaged
attention the enc-dec family's encoder and cross-attention run
(``attn_mask``, ``full_attention``, ``attention_op``, ``attention_block``).

The JAX package's tensor-parallel projections (``tp_matmul`` /
``fused_column_matmul``) are plain ``torch.matmul`` here: the port runs on
one card, and the JAX package leaves these products to XLA, outside any
Pallas kernel.  Attention against the page pool goes through
``kernels.paged_attention`` -- the hand-written CUDA kernel on a card, its
plain PyTorch version on the CPU.

Unlike the pure JAX functions, the paged blocks write the new K/V into the
page pool IN PLACE (``index_put_``); they return only the attention output.
The unpaged attention is plain torch ops (einsum, softmax), as the
reference's is jnp outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

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
# Unpaged attention (the enc-dec encoder and cross-attention)
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


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, cfg,
                 causal: bool = True,
                 kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's dispatch on one card: K/V repeated to the query
    heads, then ``full_attention`` when a valid length is given, the keys
    are at most ``cfg.attn_blockwise_threshold`` or the query is one
    token.  The blockwise branch waits for the cohort engine's slice."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if (kv_len is not None or k.shape[1] <= cfg.attn_blockwise_threshold
            or q.shape[1] == 1):
        return full_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=cfg.sliding_window, kv_len=kv_len)
    raise NotImplementedError(
        f"blockwise attention over {k.shape[1]} keys (past "
        f"attn_blockwise_threshold {cfg.attn_blockwise_threshold}) waits "
        f"for the cohort engine's slice")


def attention_block(params: dict, x: torch.Tensor, q_pos: torch.Tensor,
                    cfg, causal: bool = True) -> torch.Tensor:
    """The reference's ``attention_block`` without a cache: the Q/K/V
    projections, RoPE at ``q_pos`` on q and k (the reference ropes here
    even in the non-causal encoder), attention within ``x`` and the output
    projection.  ``x`` ``(B, S, d)`` -> ``(B, S, d)``."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    out = attention_op(q, k, v, q_pos, q_pos, cfg, causal=causal)
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
