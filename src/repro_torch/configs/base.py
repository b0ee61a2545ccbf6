"""Typed configuration (a copy of ``repro.configs.base``): ``ModelConfig``
and the arch registry, the shapes, the training and run records with the
launchers' ``apply_overrides`` and ``parse_cli``.

Pure dataclasses.  ``get_model_config`` takes the measured ``overhead``
(the ``phi_mesh`` transient factor) of an arch left at 1.0 from the port's
OWN calibration artifact, which ``python -m repro_torch.launch.dryrun
--calibrate`` writes from its traced steps: ``$REPRO_TORCH_CALIBRATION``,
else ``experiments/calibration_torch.json``.  The JAX package's
``experiments/calibration.json`` holds TPU measurements and is never read.
Without an artifact every config is as registered.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple


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
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Reduced shapes for CPU smoke tests.
SMOKE_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}


def get_shape(name: str, smoke: bool = False) -> ShapeConfig:
    table = SMOKE_SHAPES if smoke else SHAPES
    if name not in table:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(table)}")
    return table[name]


# ---------------------------------------------------------------------------
# Mesh / training / run
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    """The reference's mesh record, kept so that ``RunConfig`` and its
    dotted overrides have the same paths; the port runs on one card and
    reads none of it."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    multi_pod: bool = False


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    dtype: str = "bfloat16"
    remat: str = "full"           # none | full | dots
    microbatches: int = 1         # gradient accumulation
    optimizer_dtype: str = "float32"   # float32 | bfloat16 state compression
    grad_compression: str = "none"     # none | bf16 | int8_ef
    # The reference's collective-matmul schedule for its TP projections;
    # on one card there is no collective, and the port accepts "gspmd"
    # and ignores it.
    collectives: str = "gspmd"
    seed: int = 0
    checkpoint_every: int = 100
    # The port's own directory (the reference's is /tmp/repro_ckpt): a run
    # resumes from whatever it finds there.
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class RunConfig:
    """The reference's run record without its runtime knobs
    (``decomposition``, ``schedule``, ``tcl``, ``use_pallas``), which no
    training code reads: overriding one raises."""

    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# phi_mesh calibration artifact (launch/dryrun.py --calibrate)
# ---------------------------------------------------------------------------

#: Env var overriding the calibration artifact path (tests point it at a
#: temporary file; unset, ``experiments/calibration_torch.json`` is used
#: when present).
CALIBRATION_ENV = "REPRO_TORCH_CALIBRATION"


def calibration_path() -> str:
    override = os.environ.get(CALIBRATION_ENV)
    if override:
        return override
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, "experiments", "calibration_torch.json")


#: path -> ((mtime_ns, size) | None, parsed entries).  Keyed on the stat
#: signature, so a rewrite (``dryrun --calibrate`` mid-process) is picked
#: up without any manual invalidation.
_CAL_CACHE: Dict[str, Tuple[Optional[Tuple[int, int]],
                            Dict[str, Dict[str, float]]]] = {}

#: Calibrated per-arch scalars the artifact may carry: ``overhead`` feeds
#: ``ModelConfig.overhead``, ``act_scale`` feeds
#: ``launch.specs.activation_footprint`` (the replicated activation term
#: the mesh search reserves a card).
_CAL_FIELDS = ("overhead", "act_scale")


def _load_calibration(path: str) -> Dict[str, Dict[str, float]]:
    """``{arch: {"overhead": x, "act_scale": y}}`` from a calibration
    artifact (missing fields omitted; empty on any read or parse problem:
    calibration is advisory, never a hard dependency)."""
    try:
        st = os.stat(path)
        sig: Optional[Tuple[int, int]] = (st.st_mtime_ns, st.st_size)
    except OSError:
        sig = None
    cached = _CAL_CACHE.get(path)
    if cached is not None and cached[0] == sig:
        return cached[1]
    out: Dict[str, Dict[str, float]] = {}
    if sig is not None:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        if not isinstance(data, dict):
            data = {}
        for arch, entry in data.items():
            if arch.startswith("_") or not isinstance(entry, dict):
                continue
            fields = {}
            for f_ in _CAL_FIELDS:
                try:
                    fields[f_] = float(entry[f_])
                except (KeyError, TypeError, ValueError):
                    continue
            if fields:
                out[arch] = fields
    _CAL_CACHE[path] = (sig, out)
    return out


def calibration_overhead(arch_id: str) -> Optional[float]:
    """The measured ``phi_mesh`` overhead for one arch, or None."""
    return _load_calibration(calibration_path()).get(arch_id, {}) \
        .get("overhead")


def calibration_act_scale(arch_id: str) -> Optional[float]:
    """The measured activation-footprint scale for one arch, or None."""
    return _load_calibration(calibration_path()).get(arch_id, {}) \
        .get("act_scale")


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
    cfg = _REGISTRY[arch_id]()
    if cfg.overhead == 1.0:
        # A config left at the default overhead takes the measured one
        # from the calibration artifact; an explicit overhead always wins.
        measured = calibration_overhead(arch_id)
        if measured is not None:
            cfg = replace(cfg, overhead=max(1.0, measured))
    return cfg


def _ensure_loaded() -> None:
    # Import the arch modules lazily to avoid import cycles.
    from repro_torch.configs import archs  # noqa: F401


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def apply_overrides(cfg, overrides: Dict[str, str]):
    """Apply dotted-path CLI overrides (``--train.learning_rate 1e-4``).
    A path that names no field raises ``KeyError``."""
    for key, raw in overrides.items():
        parts = key.split(".")
        objs = [cfg]
        for p in parts:
            if not hasattr(objs[-1], "__dataclass_fields__") or \
                    p not in objs[-1].__dataclass_fields__:
                raise KeyError(f"--{key}: {type(objs[-1]).__name__} has no "
                               f"field {p!r}")
            objs.append(getattr(objs[-1], p))
        objs.pop()
        leaf, name = objs[-1], parts[-1]
        old = getattr(leaf, name)
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        elif isinstance(old, tuple):
            val = tuple(int(x) for x in raw.strip("()").split(","))
        else:
            val = raw
        new_leaf = replace(leaf, **{name: val})
        # Rebuild the chain outwards.
        for obj, part in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            new_leaf = replace(obj, **{part: new_leaf})
        cfg = new_leaf
    return cfg


def parse_cli(argv: List[str]) -> Tuple[Dict[str, str], List[str]]:
    """Split ``--key value`` (or ``--key=value``) pairs from positional
    args."""
    overrides: Dict[str, str] = {}
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                overrides[k] = v
                i += 1
            else:
                overrides[a[2:]] = argv[i + 1]
                i += 2
        else:
            rest.append(a)
            i += 1
    return overrides, rest
