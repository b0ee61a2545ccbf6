"""Typed model configuration (a copy of ``repro.configs.base``, trimmed to
``ModelConfig`` and the arch registry).

Pure dataclasses.  The JAX package additionally overrides ``overhead`` from a
calibration artifact measured on TPU meshes; that number says nothing about
an H100, so the port keeps each arch's registered value.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert FFN width
    first_k_dense: int = 0        # leading dense layers (DeepSeek-V2)
    dense_d_ff: int = 0           # FFN width of those dense layers
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank Q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256              # SSD chunk length (cache-conscious knob)
    attn_every: int = 0           # hybrid: shared attn block every N layers
    shared_attention: bool = False


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # every Nth block is sLSTM (xLSTM[7:1])
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333
    conv_width: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 32
    n_decoder_layers: int = 32
    frontend: str = "stub"        # precomputed frame embeddings


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                   # dense | moe | mla_moe | hybrid_ssm | xlstm | enc_dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    sliding_window: int = 0       # 0 = full attention
    mrope: bool = False           # multimodal rotary (Qwen2-VL)
    input_embeds: bool = False    # frontend stub provides embeddings
    # Perf knobs (cache-conscious attention: sequences >= threshold stream
    # decomposer-sized KV blocks instead of materializing (S, S) logits).
    attn_blockwise_threshold: int = 8192
    # phi_mesh transient-copy factor for the mesh-level planner (repro.plan):
    # >1 reserves HBM for the buffers the runtime keeps alive alongside the
    # resident shard (gradient buckets, all-gather destinations); calibrate
    # against dry-run HLO memory analysis via ``launch/dryrun.py --calibrate``.
    overhead: float = 1.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    notes: str = ""
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid/linear or windowed)."""
        return self.family in ("hybrid_ssm", "xlstm") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytical parameter count (embeddings + per-layer blocks)."""
        d, v = self.d_model, self.vocab_size
        total = d * v * (1 if self.tie_embeddings else 2)
        total += self._per_layer_params() * self.n_layers
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, v = self.d_model, self.vocab_size
        total = d * v * (1 if self.tie_embeddings else 2)
        per_layer = self._per_layer_params(active_only=True)
        return total + per_layer * self.n_layers

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            q_in = m.q_lora_rank or d
            qk_dim = m.nope_head_dim + m.rope_head_dim
            p = 0
            if m.q_lora_rank:
                p += d * m.q_lora_rank
            p += q_in * self.n_heads * qk_dim
            p += d * (m.kv_lora_rank + m.rope_head_dim)
            p += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        hd = self.head_dim
        return (
            d * self.n_heads * hd
            + 2 * d * self.n_kv_heads * hd
            + self.n_heads * hd * d
        )

    def _ffn_params(self, active_only: bool = False) -> int:
        d = self.d_model
        if self.moe is not None:
            mo = self.moe
            per_expert = 3 * d * (mo.d_ff_expert or self.d_ff)
            n_act = mo.top_k if active_only else mo.n_experts
            p = per_expert * (n_act + mo.n_shared_experts)
            p += d * mo.n_experts  # router
            return p
        return 3 * d * self.d_ff if self.d_ff else 0

    def _per_layer_params(self, active_only: bool = False) -> int:
        d = self.d_model
        if self.family == "hybrid_ssm":
            s = self.ssm
            d_inner = s.expand * d
            mamba = (
                d * (2 * d_inner + 2 * s.state_dim * (d_inner // s.head_dim))
                + d_inner * s.conv_width
                + d_inner * d
                + 2 * (d_inner // s.head_dim)
            )
            # Shared attention block amortized over its period (params are
            # shared, counted once per period).
            shared = 0
            if s.attn_every:
                shared = (self._attn_params() + 3 * d * self.d_ff) // s.attn_every
            return mamba + shared + 2 * d
        if self.family == "xlstm":
            x = self.xlstm
            d_in_m = int(x.mlstm_proj_factor * d)
            mlstm = d * 2 * d_in_m + d_in_m * d + 4 * d_in_m * d_in_m // max(1, self.n_heads)
            return mlstm + 2 * d
        attn = self._attn_params()
        ffn = self._ffn_params(active_only)
        return attn + ffn + 2 * d

    def reduced(self) -> "ModelConfig":
        """Smoke-test-sized variant of the same family (runs on 1 CPU)."""
        kw: dict = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            d_head=16,
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_ff_expert=32 if self.moe.d_ff_expert else 0,
                first_k_dense=min(1, self.moe.first_k_dense),
                dense_d_ff=64 if self.moe.dense_d_ff else 0,
            )
        if self.mla is not None:
            kw["mla"] = replace(
                self.mla, kv_lora_rank=16,
                q_lora_rank=16 if self.mla.q_lora_rank else 0,
                rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
            )
            kw["d_head"] = 0
        if self.ssm is not None:
            kw["ssm"] = replace(
                self.ssm, state_dim=16, head_dim=16, chunk=16,
                attn_every=min(2, self.ssm.attn_every) if self.ssm.attn_every else 0,
            )
            kw["n_layers"] = 4 if self.ssm.attn_every else 2
        if self.xlstm is not None:
            kw["xlstm"] = replace(self.xlstm, slstm_every=2)
            kw["n_layers"] = 4
        if self.enc_dec is not None:
            kw["enc_dec"] = replace(
                self.enc_dec, n_encoder_layers=2, n_decoder_layers=2
            )
        if self.sliding_window:
            kw["sliding_window"] = 32
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def get_model_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def _ensure_loaded() -> None:
    # Import the arch modules lazily to avoid import cycles.
    from repro_torch.configs import archs  # noqa: F401
