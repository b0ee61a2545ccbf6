"""The serving request record (the port of ``repro.serve.scheduler.Request``;
the cohort scheduler waits for the cohort engine's slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Hashable


@dataclass
class Request:
    """One sequence to serve. ``features`` is the engine's opaque prompt
    payload (``{"tokens": ...}``, and an enc-dec request's
    ``"enc_embeds"``); ``rid`` orders preemption (older requests outrank
    younger ones); ``state_bytes`` is its token-free cache cost
    (``serve.kvcache.request_state_bytes``: the hybrid's conv and SSM
    state, enc-dec's cross K/V, 0 for the dense family); ``group`` is
    ``(prompt_len, enc_len)``, as the reference keys it."""

    rid: int
    prompt_len: int
    max_new: int
    features: Any = None
    state_bytes: int = 0
    group: Hashable = None

    def __post_init__(self):
        self.max_new = max(1, int(self.max_new))
        if self.group is None:
            self.group = (self.prompt_len,)
