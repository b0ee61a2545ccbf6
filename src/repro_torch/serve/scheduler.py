"""The serving request record (the port of ``repro.serve.scheduler.Request``;
the cohort scheduler waits for the cohort engine's slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class Request:
    """One sequence to serve. ``features`` is the engine's opaque prompt
    payload (``{"tokens": ...}``); ``rid`` orders preemption (older
    requests outrank younger ones); ``state_bytes`` is its token-free
    cache cost (``serve.kvcache.request_state_bytes``: the hybrid's conv
    and SSM state, 0 for the dense family)."""

    rid: int
    prompt_len: int
    max_new: int
    features: Any = None
    state_bytes: int = 0

    def __post_init__(self):
        self.max_new = max(1, int(self.max_new))
