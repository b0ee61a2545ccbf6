"""Sampling for the serving engine: greedy / temperature / top-k (the port
of ``repro.serve.sampling``).

``sample`` takes the last-token logits ``(B, V)`` and returns ``(B,)``
int64 token ids.  Greedy is exact argmax.  Temperature and top-k draw from
a ``torch.Generator`` the engine seeds from ``SamplingConfig.seed`` once
per ``generate`` call, so a run replays exactly under the same seed and
schedule; the draws differ from ``jax.random``'s, so only greedy output can
match the JAX package token for token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

KINDS = ("greedy", "temperature", "top_k")


@dataclass(frozen=True)
class SamplingConfig:
    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0                 # used by kind="top_k"
    seed: int = 0
    eos_id: Optional[int] = None   # stop decoding a slot on this token

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown sampling kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.kind == "top_k" and self.top_k <= 0:
            raise ValueError("kind='top_k' needs top_k >= 1")


def make_generator(cfg: SamplingConfig, device) -> Optional[torch.Generator]:
    """The engine's per-call generator (None for greedy: no randomness)."""
    if cfg.kind == "greedy":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    return gen


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Draw one token per row of ``logits`` (B, V) -> (B,)."""
    if cfg.kind == "greedy":
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError(f"sampling kind {cfg.kind!r} needs a generator")
    scaled = logits.float() / max(1e-6, cfg.temperature)
    if cfg.kind == "top_k":
        k = min(cfg.top_k, scaled.shape[-1])
        kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
