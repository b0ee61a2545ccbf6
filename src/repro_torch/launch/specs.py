"""Input specifications for every (architecture x shape) cell (the port
of ``repro.launch.specs``).

``train_batch_specs``/``decode_batch_specs`` give each model input as a
``TensorSpec`` (shape and dtype, no storage); ``batch_logical_axes`` and
``cache_logical_axes`` their logical axes, which ``dist.sharding`` turns
into placements; ``activation_footprint``, ``overlap_wire_bytes`` and
``decode_footprint`` are the planner's rough working-set and wire sizes.
``make_batch`` draws a batch from a numpy ``Generator`` in the reference's
order and with its casts, so one seed gives both packages the same batch,
and hands it over as tensors on a device.  Modality frontends are stubs,
as in the reference: vlm batches carry precomputed patch embeddings with
M-RoPE position ids, enc_dec batches precomputed frame embeddings.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


class TensorSpec(NamedTuple):
    """A model input's shape and dtype, without storage (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def train_batch_specs(cfg, shape, dtype=torch.bfloat16
                      ) -> Dict[str, TensorSpec]:
    b, s = shape.global_batch, shape.seq_len
    ids = TensorSpec((b, s), torch.int32)
    if cfg.family == "vlm":
        return {"embeds": TensorSpec((b, s, cfg.d_model), dtype),
                "positions_3d": TensorSpec((3, b, s), torch.int32),
                "labels": ids}
    if cfg.family == "enc_dec":
        return {"enc_embeds": TensorSpec((b, s, cfg.d_model), dtype),
                "tokens": ids, "labels": ids}
    return {"tokens": ids, "labels": ids}


def decode_batch_specs(cfg, shape) -> Dict[str, TensorSpec]:
    b = shape.global_batch
    out = {"tokens": TensorSpec((b, 1), torch.int32)}
    if cfg.family == "vlm":
        # Decode generates text tokens; M-RoPE positions for the new token.
        out = {"positions_3d": TensorSpec((3, b, 1), torch.int32),
               "tokens": TensorSpec((b, 1), torch.int32)}
    return out


def batch_logical_axes(cfg, kind: str) -> Dict[str, Tuple]:
    """Logical activation axes of each batch input."""
    if kind == "decode":
        axes = {"tokens": ("batch", None)}
        if cfg.family == "vlm":
            axes["positions_3d"] = (None, "batch", None)
        return axes
    if cfg.family == "vlm":
        return {"embeds": ("batch", "seq", "embed"),
                "positions_3d": (None, "batch", "seq"),
                "labels": ("batch", "seq")}
    if cfg.family == "enc_dec":
        return {"enc_embeds": ("batch", "seq", "embed"),
                "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}


def cache_logical_axes(cfg, cache: Any, long_context: bool) -> Any:
    """Logical axes tree matching a cache tree (leaves with a ``shape``).
    The KV sequence dim shards over "model" for long-context decode, where
    the cache dominates memory; heads stay unsharded then."""
    seq_ax = "kv_seq" if long_context else None

    def axes_for(path: Tuple[str, ...], leaf) -> Tuple:
        name = path[-1]
        nd = len(getattr(leaf, "shape", ()))
        if name in ("k", "v", "cross_k", "cross_v"):
            head_ax = None if long_context else "kv_heads"
            return (("layers", "batch", seq_ax, head_ax, None)[:nd]
                    if nd == 5 else (None,) * nd)
        if name in ("ckv", "krope"):
            return ("layers", "batch", seq_ax, None)
        if name == "conv":
            return ("layers", "batch", None, "mlp")
        if name == "ssm":
            return ("layers", "batch", "state_heads", None, None)
        if name == "C":
            return ("layers", "batch", "state_heads", "state_inner", None)
        if name in ("n", "c", "h", "m"):
            return ("layers", "batch", "state_heads", "state_inner")[:nd]
        if name == "pos":
            return ()
        return (None,) * nd

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return axes_for(path, node)

    return walk(cache)


def activation_footprint(cfg, shape, remat: str = "full",
                         dtype_bytes: int = 2) -> int:
    """Rough global activation working-set bytes for one step: the residual
    stream of each resident layer (~sqrt(L) checkpoints under "full"
    remat, every layer otherwise) times a 4x block working-set factor, and
    the float32 logits.  The mesh-level decomposer reserves it (divided by
    the data extent) as its replicated term.  The whole estimate is scaled
    by the arch's measured ``act_scale`` from the port's calibration
    artifact when there is one (``launch/dryrun.py --calibrate`` fits it
    against the traced step's peak, as it fits ``overhead``); without one
    the model stands as it is."""
    from repro_torch.configs.base import calibration_act_scale

    resident_layers = (max(2, int(math.isqrt(max(1, cfg.n_layers))))
                       if remat == "full" else cfg.n_layers)
    tokens = shape.global_batch * shape.seq_len
    stream = tokens * cfg.d_model * dtype_bytes * resident_layers * 4
    logits = tokens * cfg.vocab_size * 4
    scale = calibration_act_scale(getattr(cfg, "arch", "")) or 1.0
    return int((stream + logits) * scale)


def overlap_wire_bytes(m: int, k: int, n: int, p: int, kind: str = "ag",
                       mode: str = "ring", dtype_bytes: int = 2) -> int:
    """Per-ring-step bytes one link carries for a ``(m, k) @ (k, n)``
    projection on the rings: the all-gather ring forwards the ``(m, k/p)``
    chunk, the reduce-scatter ring the ``(m/p, n)`` accumulator; the
    serpentine schedule halves either across both link directions."""
    p = max(1, p)
    if kind == "ag":
        payload = m * (k // p) * dtype_bytes
    elif kind == "rs":
        payload = (m // p) * n * dtype_bytes
    else:
        raise ValueError(f"kind must be 'ag' or 'rs', got {kind!r}")
    return payload // 2 if mode == "serpentine" else payload


def decode_footprint(cfg, shape, max_len: int, dtype_bytes: int = 2) -> int:
    """Rough global serving working-set bytes: the KV cache (latent for MLA,
    K + V heads otherwise) plus one layer's streaming activations."""
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    cache = shape.global_batch * max_len * per_tok * dtype_bytes * cfg.n_layers
    stream = shape.global_batch * shape.seq_len * cfg.d_model * dtype_bytes * 4
    return cache + stream


def make_batch(cfg, shape, rng: np.random.Generator, dtype=torch.bfloat16,
               kind: str = "train", device=None) -> Dict[str, torch.Tensor]:
    """A real batch of ``shape.global_batch`` x ``shape.seq_len``: ``tokens``
    and ``labels`` (int32) for the token families; vlm ``embeds`` (0.02 x
    a standard normal, in ``dtype``), ``positions_3d`` ``(3, B, S)`` and
    ``labels``; enc_dec ``enc_embeds``, ``tokens`` and ``labels``.
    ``kind="decode"`` gives one token a row (vlm: and zero
    ``positions_3d``)."""
    device = resolve_device(device)
    b, s = shape.global_batch, shape.seq_len

    def ints(shp):
        return torch.from_numpy(
            rng.integers(0, cfg.vocab_size, shp).astype(np.int32)).to(device)

    def embeds():
        x = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model)))
        return x.to(device=device, dtype=dtype) * 0.02

    if kind == "decode":
        out = {"tokens": ints((b, 1))}
        if cfg.family == "vlm":
            out["positions_3d"] = torch.zeros((3, b, 1), dtype=torch.int32,
                                              device=device)
        return out
    if cfg.family == "vlm":
        e = embeds()
        pos = torch.arange(s, dtype=torch.int32, device=device)
        return {"embeds": e,
                "positions_3d": pos[None, None].expand(3, b, s).contiguous(),
                "labels": ints((b, s))}
    if cfg.family == "enc_dec":
        e = embeds()
        return {"enc_embeds": e, "tokens": ints((b, s)),
                "labels": ints((b, s))}
    tokens = ints((b, s))
    return {"tokens": tokens, "labels": ints((b, s))}
