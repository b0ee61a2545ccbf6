"""Roofline terms from dry-run artifacts (the port of
``repro.roofline.report``).

Per (arch x shape x mesh), with the H100 SXM's data-sheet constants of
``hw.h100.H100Spec`` (989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4's
18 links at 25 GB/s a link and a direction) -- the reference divides by
the TPU v5e's (197 TFLOP/s, 819 GB/s, 50 GB/s a link):

  compute term    = FLOPs_per_card / peak
  memory term     = HBM_bytes_per_card / HBM_bw
  collective term = collective_bytes_per_card / (links x link_bw)

plus MODEL_FLOPS = 6*N*D (train) or 2*N_active*D (decode/prefill) and the
useful-compute ratio MODEL_FLOPS / FLOPs.  The per-card quantities come
from ``roofline.ops.analyze_ops`` (the counterpart of the reference's HLO
analysis); every term is a bound, not a measurement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.hw.h100 import H100Spec, h100_spec


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    step: str
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: Dict[str, float]
    model_flops_per_chip: float
    useful_ratio: float                 # MODEL / counted
    bottleneck: str
    step_time_bound_s: float
    mfu_bound: float                    # model-flops utilization at the bound
    ideal_bound_s: float = 0.0          # perfect-fusion/sharding bound
    roofline_fraction: float = 0.0      # ideal_bound / achieved bound

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.step} "
                f"| {self.compute_s * 1e3:.2f} | {self.memory_s * 1e3:.2f} "
                f"| {self.collective_s * 1e3:.2f} | {self.bottleneck} "
                f"| {self.useful_ratio:.2f} | {self.mfu_bound * 100:.1f}% |")


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   dtype_bytes: int = 2) -> float:
    """Global KV/state cache bytes for decode shapes."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "mla_moe":
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        return cfg.n_layers * b * s * per_tok * dtype_bytes
    if cfg.family == "hybrid_ssm":
        ssm = cfg.ssm
        d_inner = ssm.expand * cfg.d_model
        h = d_inner // ssm.head_dim
        state = cfg.n_layers * b * h * ssm.head_dim * ssm.state_dim * 4
        attn = 0
        if ssm.attn_every:
            n_apps = -(-cfg.n_layers // ssm.attn_every)
            attn = (n_apps * b * s * cfg.n_kv_heads * cfg.head_dim
                    * 2 * dtype_bytes)
        return state + attn
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import _round128
        di = _round128(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
        dh = di // cfg.n_heads
        n_m = cfg.n_layers - cfg.n_layers // cfg.xlstm.slstm_every
        return n_m * b * cfg.n_heads * dh * dh * 4
    s_kv = min(s, cfg.sliding_window) if cfg.sliding_window else s
    layers = (cfg.enc_dec.n_decoder_layers if cfg.family == "enc_dec"
              else cfg.n_layers)
    cache = layers * b * s_kv * cfg.n_kv_heads * cfg.head_dim * 2 * dtype_bytes
    if cfg.family == "enc_dec":   # cross K/V over the encoder length
        cache += (layers * b * s * cfg.n_kv_heads * cfg.head_dim
                  * 2 * dtype_bytes)
    return cache


def ideal_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Optimistic global HBM traffic for one step (perfect fusion and
    sharding): the roofline target."""
    n = cfg.param_count()
    tokens = shape.global_batch * shape.seq_len
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    if shape.kind == "train":
        # fp32 master+m+v read/write (24B) + bf16 weights read fwd/remat/bwd
        # (6B) + f32 grads write+read (8B).
        weights = n * 38.0
        acts = L * tokens * d * 2.0 * 8.0     # block in/outs, fwd+bwd
        logits = tokens * v * 2.0 * 2.0
        return weights + acts + logits
    if shape.kind == "prefill":
        weights = n * 2.0
        acts = L * tokens * d * 2.0 * 4.0
        cache = kv_cache_bytes(cfg, shape)    # written once
        return weights + acts + cache
    # decode: all (active) params + the whole cache once per token.
    active = cfg.active_param_count()
    return active * 2.0 + kv_cache_bytes(cfg, shape)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global MODEL_FLOPS for one step: 6*N*D train, 2*N*D per generated /
    prefilled token (active params for MoE)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence.
    return 2.0 * n_active * shape.global_batch


def roofline_terms(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh_name: str,
    step: str,
    summary,
    n_chips: int = 256,
    spec: Optional[H100Spec] = None,
) -> RooflineTerms:
    """The terms of one step from its per-card ``summary`` (an
    ``OpSummary``, or anything with ``flops``, ``hbm_bytes``,
    ``collective_bytes`` and ``total_collective_bytes``) on ``n_chips``
    cards of ``spec`` (default the H100 SXM)."""
    spec = spec or h100_spec()
    compute_s = summary.flops / spec.peak_bf16_flops
    memory_s = summary.hbm_bytes / spec.hbm_bw
    links = spec.nvlink_links
    collective_s = summary.total_collective_bytes / (
        links * spec.nvlink_bw_per_link)

    mf = model_flops(cfg, shape) / n_chips
    useful = mf / summary.flops if summary.flops else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    mfu = (mf / spec.peak_bf16_flops) / bound if bound else 0.0
    ideal = max(mf / spec.peak_bf16_flops,
                ideal_bytes(cfg, shape) / n_chips / spec.hbm_bw)
    return RooflineTerms(
        arch=cfg.arch, shape=shape.name, mesh=mesh_name, step=step,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_chip=summary.flops, hbm_bytes_per_chip=summary.hbm_bytes,
        collective_bytes_per_chip=summary.total_collective_bytes,
        collective_breakdown=dict(summary.collective_bytes),
        model_flops_per_chip=mf, useful_ratio=useful,
        bottleneck=bottleneck, step_time_bound_s=bound, mfu_bound=mfu,
        ideal_bound_s=ideal,
        roofline_fraction=min(1.0, ideal / bound) if bound else 0.0,
    )
