"""Training and decode batches for every family (the port of
``repro.launch.specs.make_batch``).

``make_batch`` draws a batch from a numpy ``Generator`` in the reference's
order and with its casts, so one seed gives both packages the same batch,
and hands it over as tensors on a device.  Modality frontends are stubs,
as in the reference: vlm batches carry precomputed patch embeddings with
M-RoPE position ids, enc_dec batches precomputed frame embeddings.  The
reference's abstract specs, logical axes and ``activation_footprint``
serve its sharded step, which the port has not yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device


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
