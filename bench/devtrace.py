"""The device trace of a ``--trace 1`` run, and its reduction.

``DeviceTrace`` runs ``torch.profiler`` with device activity only (the
host's operator events would take the profiler minutes to sort) over the
measured window, and keeps every kernel, copy and set on the card as
``(name, start, end)`` on the host's monotonic clock.  The profiler stamps
its events on the Unix clock or on the monotonic one, depending on the
build; the clock is told by where the events fall.

The reduction is plain interval arithmetic: the union of the device's
intervals (its busy seconds), the gaps between them, each gap labelled by
the engine span the host was in at its middle, and the time of each
kernel by name.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, float, float]


class DeviceTrace:
    """``arm()`` in set-up, ``start()`` from the window's opening callback,
    and ``stop(t1)`` once the call has ended, with the window's close:
    the profiler records on through the call's tail, so that stopping it,
    which takes seconds, delays no request, and its events are clipped to
    ``[t0, t1]``.  Its own start takes seconds too (CUPTI's set-up), so
    ``arm`` starts it in set-up in its warm-up phase, which records
    nothing, and ``start`` only steps it into recording."""

    def __init__(self):
        self.events: List[Interval] = []
        self.t0 = self.t1 = 0.0

    def arm(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1))
        self._prof.start()

    def start(self) -> None:
        self._prof.step()
        self._unix0, self.t0 = time.time_ns(), time.monotonic()

    def stop(self, t1: float) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.t1 = t1
        self._prof.stop()
        raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        del self._prof
        if not raw:
            return
        first = min(s for _, s, _ in raw)
        # Unix stamps sit near ``_unix0``; monotonic ones near ``t0``.
        unix = abs(first - self._unix0) < abs(first - self.t0 * 1e9)
        shift = (self.t0 * 1e9 - self._unix0) if unix else 0.0
        self.events = [(n, (s + shift) / 1e9, (e + shift) / 1e9)
                       for n, s, e in raw]


def clip(events: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The events' parts inside ``[lo, hi]``."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if e > lo and s < hi]


def merged(events: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The union of the events' intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(clip(events, lo, hi)))


def idle_gaps(events: Sequence[Interval], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` in which nothing ran on the device."""
    gaps, t = [], lo
    for s, e in merged(clip(events, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label(t: float, spans: Sequence[dict],
          names: Sequence[str] = ("prefill_chunk", "decode_tick")) -> str:
    """The engine span (of ``names``) the host was in at ``t``, or
    ``"neither"``."""
    for s in spans:
        if s["name"] in names and s["start"] <= t < s["end"]:
            return s["name"]
    return "neither"


def gap_breakdown(gaps: Sequence[Tuple[float, float]], spans: Sequence[dict],
                  n: int = 10) -> List[List]:
    """The idle seconds summed by what the host was doing (``total:<span>``)
    and then the longest single gaps (``gap:<span>``), ``n`` entries at
    most."""
    spans = sorted((s for s in spans
                    if s["name"] in ("prefill_chunk", "decode_tick")),
                   key=lambda s: s["start"])
    starts = [s["start"] for s in spans]

    def at(t: float) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return label(t, spans[k:k + 1]) if k >= 0 else "neither"

    labelled = [(at((a + b) / 2), b - a) for a, b in gaps]
    totals: Dict[str, float] = {}
    for name, d in labelled:
        totals[name] = totals.get(name, 0.0) + d
    out = [[f"total:{k}", v] for k, v in
           sorted(totals.items(), key=lambda kv: -kv[1])]
    longest = sorted(labelled, key=lambda x: -x[1])[:max(0, n - len(out))]
    return out + [[f"gap:{k}", d] for k, d in longest]


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, parameters and template
    arguments (``void foo<bar>(int)`` -> ``foo``)."""
    head, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            head.append(ch)
    head = "".join(head).strip()
    return head.split(" ")[-1] if head else name


def device_ops(events: Sequence[Interval], lo: float, hi: float,
               n: int = 10) -> List[List]:
    """The ``n`` kernels (by name) that took most device seconds."""
    total: Dict[str, float] = {}
    for name, s, e in clip(events, lo, hi):
        k = kernel_name(name)
        total[k] = total.get(k, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]


def seconds_of(events: Sequence[Interval], pattern: str, lo: float,
               hi: float) -> float:
    """Device seconds of the events whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(e - s for n, s, e in clip(events, lo, hi) if rx.search(n))
