"""Multi-head Latent Attention (the port of ``repro.models.mla``;
DeepSeek-V2, arXiv:2405.04434).

MLA compresses the KV cache into a rank-``kv_lora_rank`` latent plus one
shared RoPE key.  Serving attends in the absorbed form, directly over the
latent cache:

  logits_h = q_nope_h @ W_ukT_h @ c  +  q_rope_h @ k_rope
  out_h    = (probs_h @ c) @ W_uv_h

so a token costs ``kv_lora_rank + rope_head_dim`` cached values (576 for
DeepSeek-V2) instead of ``2 * n_heads * head_dim``.

One pooled buffer ``lat`` of shape (L, P, T, 1, R + dr) stores, per token,
``concat(rms_norm(ckv), roped k_rope)``.  The paged-attention kernel runs
unchanged, as in the reference: ``concat(q_lat, q_rope) @ lat`` is the MLA
logit, so the pool is passed as ``k_pages`` with that query; the kernel
scales by 1/sqrt(R + dr) where MLA wants 1/sqrt(nope + rope), so the query
is pre-scaled by their ratio; and ``probs @ ckv`` is the first R columns of
``probs @ lat``, so the same pool is ``v_pages`` and the output is sliced
to ``[..., :R]``.  The one latent is one KV head: at DeepSeek-V2's widths
the kernel sees 128 query heads over it at D 576, which its ``mla`` body
takes on the card.

As in ``layers``, the paged blocks write the latent rows into the pool IN
PLACE and return only the attention output.  ``mla_attention`` is the
unpaged form: expanded (K and V up-projected from the latent; the
training form) without a cache, absorbed over a contiguous latent cache
(``ckv``, ``krope``) with one -- what the cohort engine's prefill and
decode run -- its rows written into the cache in place.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import local_rows_heads, rows_heads_roles
from repro_torch.models.layers import (NEG_INF, apply_rope, pool_slots,
                                       pool_write_attend, rms_norm,
                                       tp_matmul)
from repro_torch.models.params import ParamSpec


def mla_param_specs(cfg, layers: int = 0) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    specs = {
        "wkv_a": ParamSpec(ls + (d, m.kv_lora_rank + m.rope_head_dim),
                           la + ("embed", None)),
        "kv_norm": ParamSpec(ls + (m.kv_lora_rank,), la + (None,),
                             init="ones"),
        "wk_b": ParamSpec(ls + (m.kv_lora_rank, h, m.nope_head_dim),
                          la + (None, "heads", None)),
        "wv_b": ParamSpec(ls + (m.kv_lora_rank, h, m.v_head_dim),
                          la + (None, "heads", None)),
        "wo": ParamSpec(ls + (h, m.v_head_dim, d),
                        la + ("heads", None, "embed"),
                        scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers))),
    }
    if m.q_lora_rank:
        specs["wq_a"] = ParamSpec(ls + (d, m.q_lora_rank),
                                  la + ("embed", None))
        specs["q_norm"] = ParamSpec(ls + (m.q_lora_rank,), la + (None,),
                                    init="ones")
        specs["wq_b"] = ParamSpec(ls + (m.q_lora_rank, h, qk),
                                  la + (None, "heads", None))
    else:
        specs["wq"] = ParamSpec(ls + (d, h, qk), la + ("embed", "heads", None))
    return specs


def _rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a down-projection with no tensor-parallel dim (the
    compressed query's): on a mesh each rank takes its own rows with the
    weight whole, since DTensor's propagation of the weight gradient's
    product refuses the uneven strided token shards the backward brings
    on a pod mesh."""
    if not isinstance(x, DTensor):
        return x @ w
    return local_rows_heads(lambda x, w: x @ w,
                            [(x, 0, None), (w, None, None)], [(0, None)],
                            rows_heads_roles(x, 0, None))


def _project_q(params: dict, x: torch.Tensor, cfg
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q_nope (B,S,H,dn), q_rope (B,S,H,dr))``."""
    m = cfg.mla
    if m.q_lora_rank:
        x = rms_norm(_rows_matmul(x, params["wq_a"].to(x.dtype)),
                     params["q_norm"], cfg.norm_eps)
        w = params["wq_b"].to(x.dtype)                     # (r, H, qk)
    else:
        w = params["wq"].to(x.dtype)                       # (d, H, qk)
    # One product over the flattened heads (einsum "bsr,rhe->bshe"): on a
    # mesh a column-parallel matmul, whose backward DTensor propagates
    # without the strided token shards its einsum decomposition made.
    q = (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    return q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]


def mla_attention(params: dict, x: torch.Tensor, q_pos: torch.Tensor,
                  cfg, cache: Optional[dict] = None) -> torch.Tensor:
    """MLA over ``x`` ``(B, S, d)`` at positions ``q_pos`` ``(S,)``,
    causal.  Without a cache, the expanded form: K and V up-projected from
    the latent, attention within ``x``.  With one (a layer's ``{"ckv": (B,
    W, R), "krope": (B, W, dr), "len": host counter}``), the absorbed
    form: the new latent rows are written IN PLACE at ``len`` (which
    advances by ``S``), and the queries, with ``W_uk`` absorbed, attend
    over the whole cache, masked causally and at ``len + S``.  Returns
    ``(B, S, d)``."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = _project_q(params, x, cfg)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
    kv = x @ params["wkv_a"].to(x.dtype)                     # (B,S,R+dr)
    ckv = rms_norm(kv[..., :m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], q_pos,
                        cfg.rope_theta)[:, :, 0]             # (B,S,dr)

    if cache is None:                                        # expanded
        k_nope = torch.einsum("bsr,rhe->bshe", ckv,
                              params["wk_b"].to(x.dtype))
        v = torch.einsum("bsr,rhe->bshe", ckv, params["wv_b"].to(x.dtype))

        def attend(q_nope, k_nope, q_rope, k_rope, v):
            logits = (torch.einsum("bqhe,bkhe->bhqk", q_nope, k_nope)
                      + torch.einsum("bqhe,bke->bhqk", q_rope, k_rope)
                      ).float() * scale
            mask = q_pos[None, :] <= q_pos[:, None]
            logits = logits.masked_fill(~mask, NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            return torch.einsum("bhqk,bkhe->bqhe", probs, v)  # (B,S,H,dv)

        if isinstance(q_nope, DTensor):
            # On a mesh each rank attends over its own rows and heads (the
            # shared rope key replicates over the heads' axes): DTensor's
            # batched products of the flattened (batch, heads) refuse
            # uneven strided shards.
            out = local_rows_heads(
                attend, [(q_nope, 0, 2), (k_nope, 0, 2), (q_rope, 0, 2),
                         (k_rope, 0, None), (v, 0, 2)], [(0, 2)],
                rows_heads_roles(q_nope, 0, 2))
        else:
            out = attend(q_nope, k_nope, q_rope, k_rope, v)
    else:                                                    # absorbed
        idx = int(cache["len"])
        s = x.shape[1]
        cache["ckv"][:, idx:idx + s] = ckv
        cache["krope"][:, idx:idx + s] = k_rope
        cache["len"] += s
        ckv_all = cache["ckv"].to(x.dtype)                   # (B,W,R)
        kr_all = cache["krope"].to(x.dtype)                  # (B,W,dr)
        q_lat = torch.einsum("bqhe,rhe->bqhr", q_nope,
                             params["wk_b"].to(x.dtype))
        k_pos = torch.arange(ckv_all.shape[1], device=x.device)
        mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos < idx + s)[None]

        def attend_latent(q_lat, ckv_all, q_rope, kr_all):
            logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_all)
                      + torch.einsum("bqhe,bke->bhqk", q_rope, kr_all)
                      ).float() * scale
            logits = logits.masked_fill(~mask, NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            return torch.einsum("bhqk,bkr->bqhr", probs, ckv_all)

        if isinstance(q_lat, DTensor):
            # As the expanded form: each rank's rows and heads, the shared
            # latent rows replicated over the heads' axes.
            o_lat = local_rows_heads(
                attend_latent, [(q_lat, 0, 2), (ckv_all, 0, None),
                                (q_rope, 0, 2), (kr_all, 0, None)],
                [(0, 2)], rows_heads_roles(q_lat, 0, 2))
        else:
            o_lat = attend_latent(q_lat, ckv_all, q_rope, kr_all)
        out = torch.einsum("bqhr,rhe->bqhe", o_lat,
                           params["wv_b"].to(x.dtype))
    return _out_proj(out, params["wo"].to(x.dtype))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhe,hed->bqd", out, wo)`` as the row-parallel product of
    the flattened heads (``layers.tp_matmul``): on a mesh it runs on local
    shards."""
    b, s, h, e = out.shape
    return tp_matmul(out.reshape(b, s, h * e), wo.reshape(h * e, -1), "row")


def _mla_latent_row(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project ``x`` to its latent-cache rows and absorbed queries.

    ``positions``: broadcastable to (B, S).  Returns ``(q_cat (B,S,H,R+dr)
    pre-scaled for the paged kernel, lat (B,S,R+dr))``."""
    m = cfg.mla
    q_nope, q_rope = _project_q(params, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q_lat = torch.einsum("bqhe,rhe->bqhr", q_nope,
                         params["wk_b"].to(x.dtype))

    kv = x @ params["wkv_a"].to(x.dtype)
    ckv = rms_norm(kv[..., :m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]

    lat_dim = m.kv_lora_rank + m.rope_head_dim
    ratio = math.sqrt(lat_dim) / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    q_cat = torch.cat([q_lat, q_rope], dim=-1) * ratio
    lat = torch.cat([ckv, k_rope], dim=-1)               # (B,S,R+dr)
    return q_cat, lat


def _mla_out(params: dict, o_lat: torch.Tensor, x_dtype) -> torch.Tensor:
    """Latent kernel output (...,H,R) -> d_model via wv_b, then wo."""
    out = torch.einsum("bqhr,rhe->bqhe", o_lat, params["wv_b"].to(x_dtype))
    return _out_proj(out, params["wo"].to(x_dtype))


def paged_mla_attention_block(
    params: dict,
    x: torch.Tensor,               # (S, 1, d) -- one decode token per slot
    pos: torch.Tensor,             # (S,) per-slot absolute position
    cfg,
    lat_pool: torch.Tensor,        # (L, P, T, 1, R+dr) latent page pool
    layer: int,
    table: torch.Tensor,           # (S, NP) int32 page table
) -> torch.Tensor:
    """Per-slot absorbed-form MLA decode against the latent page pool: the
    new token's latent row is written IN PLACE at ``table[s, pos // T]``,
    offset ``pos % T`` (empty slots: the null page), then every row
    attends over its pages with length ``pos + 1``.  Returns (S, 1, d)."""
    q_cat, lat = _mla_latent_row(params, x, pos[:, None], cfg)
    o_lat = _latent_write_attend(q_cat[:, 0], lat[:, 0], cfg, lat_pool,
                                 layer, table, pos)
    return _mla_out(params, o_lat[:, None], x.dtype)


def paged_mla_prefill_block(
    params: dict,
    x: torch.Tensor,               # (1, C, d) -- one prompt chunk
    positions: torch.Tensor,       # (C,) absolute positions of the chunk
    cfg,
    lat_pool: torch.Tensor,        # (L, P, T, 1, R+dr)
    layer: int,
    table_row: torch.Tensor,       # (NP,) int32 -- ONE slot's page table
) -> torch.Tensor:
    """One prompt chunk's MLA attention: its latent rows written IN PLACE
    into the slot's pages, then each chunk token attends as a decode row
    of length ``position + 1`` over the same table (the kernel's per-row
    length mask is the causal mask).  Returns (1, C, d)."""
    c = x.shape[1]
    q_cat, lat = _mla_latent_row(params, x, positions[None, :], cfg)
    table = table_row[None, :].expand(c, table_row.shape[0]).contiguous()
    o_lat = _latent_write_attend(q_cat[0], lat[0], cfg, lat_pool, layer,
                                 table, positions)
    return _mla_out(params, o_lat[None], x.dtype)


def _latent_write_attend(q_cat: torch.Tensor, lat: torch.Tensor, cfg,
                         lat_pool: torch.Tensor, layer: int,
                         table: torch.Tensor, positions: torch.Tensor
                         ) -> torch.Tensor:
    """The rows' latent ``lat`` (N, R+dr) written into the pool at
    ``positions`` through ``table`` (N, NP), then the absorbed queries
    ``q_cat`` (N, H, R+dr) against it: the paged kernel over one KV head
    whose pool is both K and V (``layers.pool_write_attend``: on a mesh on
    local shards, the queries' rows over the data axes and their heads as
    ``_project_q`` shards them).  Returns the latent output (N, H, R)."""
    t = lat_pool.shape[2]
    page_ids, off = pool_slots(table, positions, t)
    o_lat = pool_write_attend(q_cat, lat[:, None], None, lat_pool, lat_pool,
                              layer, page_ids, off, table,
                              (positions.long() + 1).to(torch.int32),
                              cfg.sliding_window or 0, t)
    return o_lat[..., :cfg.mla.kv_lora_rank]
