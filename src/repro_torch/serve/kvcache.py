"""Paged KV cache sizing (the port of the part of ``repro.serve.kvcache``
the paged engine reads).

  * ``kv_token_bytes`` / ``request_state_bytes`` -- the per-family memory
    model: the token-proportional KV term and the token-free state term.
  * ``PageSpec`` -- page math: tokens -> pages -> capacity -> global bytes,
    the units the engine budgets in, read off the plan's page level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import HierarchicalPlan

#: Fallback page size (tokens) for families with no paged KV at all
#: (pure-recurrent xLSTM: the planner has no page level to size).
DEFAULT_PAGE_TOKENS = 64


# ---------------------------------------------------------------------------
# Per-family KV memory model
# ---------------------------------------------------------------------------


def kv_token_bytes(cfg: ModelConfig, dtype_bytes: int = 2
                   ) -> Tuple[int, int, int]:
    """``(bytes_per_token, kv_layers, kv_heads)`` of the growing KV state.

    ``bytes_per_token`` is the *global* per-token footprint across all KV
    layers and heads (per-token KV bytes x heads x layers),
    ``kv_layers`` how many layers hold a per-token cache, and ``kv_heads``
    the head extent the mesh level may shard (0 = not head-shardable:
    MLA's latent cache is rank-compressed, not per-head).  Families whose
    caches are token-count-independent (xLSTM; the SSM part of hybrids)
    return ``(0, 0, 0)`` -- their cost is all in
    ``request_state_bytes``.
    """
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        per_layer = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        return per_layer * dtype_bytes * cfg.n_layers, cfg.n_layers, 0
    if cfg.family == "hybrid_ssm":
        s = cfg.ssm
        n_apps = -(-cfg.n_layers // s.attn_every) if s.attn_every else 0
        if not n_apps:
            return 0, 0, 0
        return 2 * kv * hd * dtype_bytes * n_apps, n_apps, kv
    if cfg.family == "xlstm":
        return 0, 0, 0
    if cfg.family == "enc_dec":
        nd = cfg.enc_dec.n_decoder_layers
        return 2 * kv * hd * dtype_bytes * nd, nd, kv
    return 2 * kv * hd * dtype_bytes * cfg.n_layers, cfg.n_layers, kv


def request_state_bytes(cfg: ModelConfig, enc_len: int = 0,
                        dtype_bytes: int = 2) -> int:
    """Per-sequence, token-count-independent cache bytes (the scheduler's
    fixed admission cost): SSM conv+state buffers, xLSTM matrix states,
    enc-dec cross K/V (proportional to the *encoder* length, pinned at
    admission).  Mirrors ``Model.init_cache`` shapes per batch element.
    """
    d = cfg.d_model
    if cfg.family == "hybrid_ssm":
        s = cfg.ssm
        d_inner = s.expand * d
        h = d_inner // s.head_dim
        conv_ch = d_inner + 2 * s.state_dim
        conv = cfg.n_layers * (s.conv_width - 1) * conv_ch * dtype_bytes
        ssm = cfg.n_layers * h * s.head_dim * s.state_dim * 4  # fp32
        return conv + ssm
    if cfg.family == "xlstm":
        x = cfg.xlstm
        di = -(-int(x.mlstm_proj_factor * d) // 128) * 128  # _round128
        h = cfg.n_heads
        dh, dhs = di // h, d // h
        n_s = cfg.n_layers // x.slstm_every
        n_m = cfg.n_layers - n_s
        mlstm = n_m * ((x.conv_width - 1) * di * dtype_bytes
                       + (h * dh * dh + h * dh + h) * 4)
        slstm = n_s * 4 * h * dhs * 4
        return mlstm + slstm
    if cfg.family == "enc_dec":
        nd = cfg.enc_dec.n_decoder_layers
        return 2 * nd * enc_len * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    return 0


# ---------------------------------------------------------------------------
# Page math
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PageSpec:
    """The serving engine's allocation granule, read off the plan tree.

    ``page_tokens`` comes from the decode plan's page level;
    ``token_bytes`` is the *global* per-token KV footprint (all layers,
    unsharded), so ``page_bytes = page_tokens * token_bytes`` is what one
    page costs the fleet-wide budget the scheduler enforces.
    """

    page_tokens: int
    token_bytes: int

    @property
    def page_bytes(self) -> int:
        return self.page_tokens * self.token_bytes

    def pages_for(self, tokens: int) -> int:
        return max(1, -(-max(0, tokens) // self.page_tokens))


def page_spec_from_plan(plan: Optional[HierarchicalPlan],
                        cfg: ModelConfig,
                        dtype_bytes: int = 2) -> PageSpec:
    """PageSpec from a decode plan tree (fallback when no page level --
    token-free families -- keeps the scheduler's units well defined)."""
    tok_bytes, _, _ = kv_token_bytes(cfg, dtype_bytes)
    page = plan.page_plan() if plan is not None else None
    if page is None:
        return PageSpec(page_tokens=DEFAULT_PAGE_TOKENS,
                        token_bytes=tok_bytes)
    return PageSpec(page_tokens=int(page["page_tokens"]),
                    token_bytes=tok_bytes)
