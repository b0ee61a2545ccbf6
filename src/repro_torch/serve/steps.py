"""The serving steps (the port of ``repro.serve.steps`` on one card):
plain callables around the model's steps, run eagerly without autograd.
``make_serve_steps`` binds the cohort engine's prefill (into a cache of
``max_len`` tokens) and decode step; ``make_paged_steps`` the paged
engine's decode step, chunked prefill and (enc_dec) admission-time
encoder pass.  The reference's sharding fields wait for the distribution
slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.models.model import Model

PyTree = Any


@dataclass(frozen=True)
class ServeSteps:
    """``prefill(params, batch)`` -> ``(logits, cache)`` with a cache of
    the bound capacity (``Model.prefill``), and ``decode(params, cache,
    batch)`` -> ``(logits, cache)`` (``Model.decode_step``)."""

    prefill: Callable
    decode: Callable
    model: Model


def make_serve_steps(model: Model, max_len: int,
                     dtype=torch.bfloat16) -> ServeSteps:
    """Bind the model's cohort steps to the cache capacity ``max_len``
    and the compute ``dtype``."""

    def prefill(params: PyTree, batch):
        with torch.no_grad():
            return model.prefill(params, batch, max_len, dtype=dtype)

    def decode(params: PyTree, cache: PyTree, batch):
        with torch.no_grad():
            return model.decode_step(params, cache, batch, dtype=dtype)

    return ServeSteps(prefill=prefill, decode=decode, model=model)


@dataclass(frozen=True)
class PagedServeSteps:
    """``decode(params, cache, batch)`` and ``prefill_chunk(params, cache,
    tokens, pos0, slot)``, each returning ``(logits, cache)``; for enc_dec,
    ``encode(params, enc_embeds)`` returning the request's cross K/V
    (``Model.encode_cross``), else None."""

    decode: Callable
    prefill_chunk: Callable
    model: Model
    encode: Optional[Callable] = None


def make_paged_steps(model: Model, dtype=torch.bfloat16) -> PagedServeSteps:
    """Bind the model's paged steps to the compute ``dtype``."""

    def decode(params: PyTree, cache: PyTree, batch):
        with torch.no_grad():
            return model.decode_step_paged(params, cache, batch, dtype=dtype)

    def prefill_chunk(params: PyTree, cache: PyTree, tokens, pos0, slot):
        with torch.no_grad():
            return model.prefill_chunk(
                params, cache, {"tokens": tokens, "pos0": pos0,
                                "slot": slot}, dtype=dtype)

    encode = None
    if model.cfg.family == "enc_dec":
        def encode(params: PyTree, enc_embeds):
            with torch.no_grad():
                return model.encode_cross(
                    params, {"enc_embeds": enc_embeds}, dtype=dtype)

    return PagedServeSteps(decode=decode, prefill_chunk=prefill_chunk,
                           model=model, encode=encode)
