"""The paged serving steps (the port of ``repro.serve.steps.
make_paged_steps``): two plain callables around the model's paged decode
step and chunked prefill, run eagerly without autograd."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.model import Model

PyTree = Any


@dataclass(frozen=True)
class PagedServeSteps:
    """``decode(params, cache, batch)`` and ``prefill_chunk(params, cache,
    tokens, pos0, slot)``, each returning ``(logits, cache)``."""

    decode: Callable
    prefill_chunk: Callable
    model: Model


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

    return PagedServeSteps(decode=decode, prefill_chunk=prefill_chunk,
                           model=model)
