"""Fault-tolerance primitives for long runs (a copy of
``repro.ft.resilience``: pure Python).

  * ``PreemptionHandler`` -- SIGTERM/SIGINT -> ``should_stop`` flag the
    training loop polls each step; the loop then takes a final synchronous
    checkpoint and exits cleanly (preemption notices arrive this way).
  * ``StepWatchdog`` -- wall-clock deadline per step. On expiry it invokes a
    callback (log, checkpoint, or abort). At the 1000-node scale the same
    watchdog drives *straggler mitigation*: a host that repeatedly trips the
    deadline is declared slow and the launcher swaps in a hot spare, then
    the job resumes from the last checkpoint on the refreshed slice (the
    data pipeline being stateless-resumable makes the swap coordination
    free).
  * ``StragglerPolicy`` -- bookkeeping for per-host step latencies with a
    robust (median + k*MAD) slowness test; pure logic, unit-testable.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                pass  # non-main thread (tests)
        return self

    def _on_signal(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self) -> None:   # for tests / manual drain
        self._stop.set()

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)


class StepWatchdog:
    """Fires ``on_timeout(step, elapsed)`` if a step exceeds its deadline."""

    def __init__(self, deadline_s: float,
                 on_timeout: Callable[[int, float], None]):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._step = -1
        self._t0 = 0.0

    def start_step(self, step: int) -> None:
        self.cancel()
        self._step, self._t0 = step, time.monotonic()
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self) -> None:
        self.on_timeout(self._step, time.monotonic() - self._t0)

    def end_step(self) -> None:
        self.cancel()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


@dataclass
class StragglerPolicy:
    """Median + k*MAD slowness detector over per-host step times."""

    k: float = 4.0
    min_samples: int = 8
    history: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        self.history.setdefault(host, []).append(step_time)

    def _recent(self, host: int, n: int = 16) -> List[float]:
        return self.history.get(host, [])[-n:]

    def stragglers(self) -> List[int]:
        import statistics

        means = {}
        for host, times in self.history.items():
            recent = self._recent(host)
            if len(recent) >= self.min_samples:
                means[host] = statistics.median(recent)
        if len(means) < 2:
            return []
        med = statistics.median(means.values())
        mad = statistics.median(abs(v - med) for v in means.values()) or 1e-9
        return sorted(h for h, v in means.items() if v > med + self.k * mad)

    def replacement_plan(self, spares: List[int]) -> Dict[int, int]:
        """Map straggler host -> spare host (documented launcher protocol:
        drain straggler, restore latest checkpoint on spare, resume)."""
        out = {}
        for straggler, spare in zip(self.stragglers(), spares):
            out[straggler] = spare
        return out

    def forget(self, host: int) -> None:
        """Drop a host's latency history (cluster router un-drain: a
        drained replica re-admitted to service must re-earn a straggler
        verdict from fresh samples, not inherit its pre-drain tail)."""
        self.history.pop(host, None)
