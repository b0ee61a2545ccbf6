"""The serving request record (the port of ``repro.serve.scheduler.Request``;
the cohort scheduler waits for the cohort engine's slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class Request:
    """One sequence to serve. ``features`` is the engine's opaque prompt
    payload (``{"tokens": ...}``); ``rid`` orders preemption (older
    requests outrank younger ones)."""

    rid: int
    prompt_len: int
    max_new: int
    features: Any = None

    def __post_init__(self):
        self.max_new = max(1, int(self.max_new))
