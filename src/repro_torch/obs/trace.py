"""Span tracer with Chrome/Perfetto ``trace_event`` JSON export.

DESIGN.md §13.  One ``Tracer`` per engine (``pid`` = replica id) plus
one for the router, all sharing a module-level monotonic epoch -- so a
cluster trace merged with ``merge_events`` shows the whole fleet on a
single timeline.  Request lifecycle rides on ``tid = rid + 1``
(admission -> queue-wait -> prefill-chunk[i] -> first-token -> finish);
engine-wide decode ticks ride on ``tid = 0``; pool alloc/free, prefix
hit/evict, CoW copies and router placements are instant events.

Events live in a bounded ring (old events drop, ``dropped`` counts
them) -- the same policy ``RingLog`` applies to the engine's legacy
``interleave``/``token_times`` metrics, which previously grew without
limit over an engine's lifetime.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, List, Optional

# Single timeline zero for every tracer in this process: thread-transport
# replicas and the router all subtract the same epoch, so their ``ts``
# values interleave correctly in one exported trace.
_EPOCH = time.monotonic()


class RingLog:
    """A bounded append-only log that quacks like the list it replaced.

    ``maxlen`` caps residency; overflow evicts the oldest entry and
    bumps ``dropped``.  Supports the exact read patterns the benchmark
    harness uses on ``metrics["interleave"]`` / ``metrics["token_times"]``:
    iteration, ``len``, indexing, and list concatenation on either side
    (``[t0] + ring``)."""

    def __init__(self, maxlen: int = 65536,
                 init: Optional[Iterable[Any]] = None) -> None:
        self.maxlen = int(maxlen)
        self._d: deque = deque(maxlen=self.maxlen)
        self.dropped = 0
        for x in init or ():
            self.append(x)

    def append(self, x: Any) -> None:
        if len(self._d) == self.maxlen:
            self.dropped += 1
        self._d.append(x)

    def clear(self) -> None:
        """Drop contents but keep the ``dropped`` count -- recompute
        preemption resets a request's token times without hiding that
        earlier entries were shed."""
        self._d.clear()

    def __iter__(self) -> Iterator[Any]:
        return iter(list(self._d))

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._d)[i]
        return self._d[i]

    def __add__(self, other):
        return list(self._d) + list(other)

    def __radd__(self, other):
        return list(other) + list(self._d)

    def __eq__(self, other):
        return list(self._d) == list(other)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RingLog({list(self._d)!r}, dropped={self.dropped})"


class Tracer:
    """Nestable spans + instant events in a bounded ring buffer.

    Emits Chrome ``trace_event`` dicts: ``B``/``E`` pairs from
    ``span()``/``begin()``/``end()``, retroactive ``X`` complete events
    from ``complete()`` (for durations measured across scheduler ticks,
    e.g. queue wait), and ``i`` instants.  Timestamps are microseconds
    relative to the process-wide monotonic epoch."""

    def __init__(self, capacity: int = 65536, pid: int = 0,
                 process_name: Optional[str] = None,
                 enabled: bool = True) -> None:
        self.capacity = int(capacity)
        self.pid = int(pid)
        self.process_name = process_name or f"replica-{self.pid}"
        self.enabled = enabled
        self.dropped = 0
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    # -- time ----------------------------------------------------------
    @staticmethod
    def now() -> float:
        """Monotonic seconds; pass these to ``complete``."""
        return time.monotonic()

    @staticmethod
    def _us(t: float) -> float:
        return (t - _EPOCH) * 1e6

    # -- recording -----------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)

    def _event(self, ph: str, name: str, tid: int, ts: float,
               args: Optional[Dict[str, Any]] = None,
               **extra: Any) -> Dict[str, Any]:
        ev: Dict[str, Any] = {"name": name, "ph": ph, "ts": self._us(ts),
                              "pid": self.pid, "tid": int(tid)}
        if args:
            ev["args"] = dict(args)
        ev.update(extra)
        return ev

    def begin(self, name: str, tid: int = 0,
              args: Optional[Dict[str, Any]] = None) -> None:
        if self.enabled:
            self._push(self._event("B", name, tid, time.monotonic(), args))

    def end(self, name: str, tid: int = 0) -> None:
        if self.enabled:
            self._push(self._event("E", name, tid, time.monotonic()))

    @contextmanager
    def span(self, name: str, tid: int = 0,
             args: Optional[Dict[str, Any]] = None):
        self.begin(name, tid, args)
        try:
            yield self
        finally:
            self.end(name, tid)

    def complete(self, name: str, t_start: float, t_end: float,
                 tid: int = 0,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Retroactive span from monotonic seconds ``t_start``..``t_end``
        (an ``X`` event) -- for durations that close long after they
        open, like queue wait or a whole request lifetime."""
        if self.enabled:
            self._push(self._event("X", name, tid, t_start, args,
                                   dur=max(0.0, (t_end - t_start) * 1e6)))

    def instant(self, name: str, tid: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        if self.enabled:
            self._push(self._event("i", name, tid, time.monotonic(), args,
                                   s="t"))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # -- export --------------------------------------------------------
    def export_events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """The recorded events (oldest first), optionally only the last
        ``last`` of them."""
        with self._lock:
            evs = list(self._ring)
        if last is not None and last >= 0:
            evs = evs[-last:]
        return evs

    def metadata_events(self) -> List[Dict[str, Any]]:
        return [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": self.process_name}}]

    def chrome_events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        return self.metadata_events() + self.export_events(last)

    def export_chrome(self, path: str, last: Optional[int] = None) -> str:
        """Write a Chrome/Perfetto-loadable JSON trace; returns path."""
        return write_chrome(path, self.chrome_events(last))


def merge_events(*event_lists: Iterable[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Merge per-tracer event lists onto one timeline.  Metadata events
    lead; the rest sort by timestamp (stable, so B/E order within one
    tracer's equal-ts events survives)."""
    meta: List[Dict[str, Any]] = []
    evs: List[Dict[str, Any]] = []
    for lst in event_lists:
        for ev in lst:
            (meta if ev.get("ph") == "M" else evs).append(ev)
    evs.sort(key=lambda e: e.get("ts", 0.0))
    return meta + evs


def write_chrome(path: str, events: List[Dict[str, Any]]) -> str:
    with open(path, "w") as f:
        json.dump({"traceEvents": list(events), "displayTimeUnit": "ms"},
                  f, indent=None, separators=(",", ":"))
    return path


def validate_events(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Schema check for exported events; returns a list of problems
    (empty == loadable).  Used by the ``--only obs --dry`` CI gate and
    the export tests: required keys, known phases, non-negative
    relative timestamps/durations, balanced well-nested B/E per
    (pid, tid) in record order."""
    problems: List[str] = []
    stacks: Dict[tuple, List[str]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            if "name" not in ev or "args" not in ev:
                problems.append(f"event {i}: metadata missing name/args")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ph not in ("B", "E", "X", "i"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X without dur")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            problems.append(f"event {i}: instant without scope")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(f"event {i}: E without open B on {key}")
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed spans on {key}: {stack}")
    return problems
