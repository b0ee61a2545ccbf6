"""Typed metrics spine: Counter / Gauge / Histogram in a Registry.

DESIGN.md §13.  The serving layers (``ServeEngine``, ``PagePool``,
``RadixPrefixCache``, ``Router``) all write into one ``Registry`` per
engine/router instead of ad-hoc ``self.metrics`` dicts.  The old dict
API survives as ``MetricsView`` -- a MutableMapping over the registry
plus a side table for the non-scalar entries (``batching``,
``interleave``, ``token_times``, ...) -- so every existing consumer
(``benchmarks/run.py``, launcher printouts, the cluster tests) keeps
reading the keys it always read.

Zero dependencies: histograms are fixed log-spaced buckets (bounds
``lo * growth**i``), so ``percentile(p)`` is a cumulative-count walk
with relative error bounded by ``growth``; the Prometheus text
exposition is hand-rolled (format version 0.0.4).
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

try:  # pragma: no cover - py<3.9 fallback never hit in-repo
    from collections.abc import MutableMapping
except ImportError:  # pragma: no cover
    from collections import MutableMapping  # type: ignore


class Counter:
    """Monotonic count.  ``inc`` by a negative amount raises -- that is
    the satellite fix for ``metrics["tokens"]`` going transiently
    negative on recompute preemption: preempted work moves into its own
    ``tokens_recomputed`` counter instead of subtracting."""

    kind = "counter"

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {n}")
        self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {self.name: self.value}


class Gauge:
    """Point-in-time value; ``set_max`` tracks peaks (pool occupancy,
    resident bytes) without a separate high-watermark variable."""

    kind = "gauge"

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self.value: Any = 0

    def set(self, v: Any) -> None:
        self.value = v

    def add(self, v: float) -> None:
        self.value = (self.value or 0) + v

    def set_max(self, v: float) -> None:
        cur = self.value
        if not isinstance(cur, (int, float)) or v > cur:
            self.value = v

    def snapshot(self) -> Dict[str, Any]:
        return {self.name: self.value}


class Histogram:
    """Fixed log-bucket latency histogram.

    Bucket ``i`` holds values in ``(lo*g**(i-1), lo*g**i]``; values
    below ``lo`` land in bucket 0, values above ``hi`` in the overflow
    bucket.  ``percentile`` returns the upper bound of the bucket that
    contains the rank-``ceil(q*count)`` observation, so against a
    sorted-list oracle the relative error is at most ``growth`` for
    in-range values (tested in tests/test_obs.py)."""

    kind = "histogram"

    def __init__(self, name: str, unit: str = "s", lo: float = 1e-6,
                 hi: float = 1e3, growth: float = 2.0 ** 0.25) -> None:
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("histogram needs lo>0, hi>lo, growth>1")
        self.name = name
        self.unit = unit
        self.lo = lo
        self.growth = growth
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self.bounds: List[float] = [lo * growth ** i for i in range(n + 1)]
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        # smallest i with bounds[i] >= v; v past the last bound lands in
        # the overflow bucket (index len(bounds)).
        self.counts[bisect.bisect_left(self.bounds, v)] += 1

    def percentile(self, p: float) -> float:
        """p in [0, 100].  Returns 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(math.ceil(p / 100.0 * self.count)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i < len(self.bounds):
                    return self.bounds[i]
                return self.max  # overflow bucket: best bound we have
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            f"{self.name}.count": self.count,
            f"{self.name}.mean": self.mean,
            f"{self.name}.p50": self.percentile(50),
            f"{self.name}.p95": self.percentile(95),
            f"{self.name}.p99": self.percentile(99),
        }


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "repro_" + _PROM_BAD.sub("_", name)


def _prom_labels(labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_lines(values: Mapping[str, Any],
                     labels: Optional[Mapping[str, str]] = None) -> List[str]:
    """Text-exposition lines for a flat name->scalar mapping (e.g. a
    remote replica's ``Registry.snapshot()`` forwarded in ReplicaStats).
    Non-numeric values are skipped."""
    out: List[str] = []
    lab = _prom_labels(labels)
    for name in sorted(values):
        v = values[name]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if isinstance(v, float) and not math.isfinite(v):
            continue
        out.append(f"{_prom_name(name)}{lab} {v}")
    return out


class Registry:
    """Ordered, lazily-created instruments keyed by name.

    ``counter``/``gauge``/``histogram`` are get-or-create (a name keeps
    its first type; asking for the same name as a different type
    raises).  ``snapshot()`` flattens to a JSON-/pickle-safe dict --
    the exact payload ``ReplicaStats.metrics`` carries over the cluster
    transports."""

    def __init__(self) -> None:
        self._m: "Dict[str, Any]" = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kw):
        with self._lock:
            m = self._m.get(name)
            if m is None:
                m = self._m[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {m.kind}, "
                                f"not a {cls.__name__.lower()}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get_or_create(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, unit=unit)

    def histogram(self, name: str, unit: str = "s", **kw) -> Histogram:
        return self._get_or_create(name, Histogram, unit=unit, **kw)

    # -- convenience write paths (create-on-first-use) -----------------
    def inc(self, name: str, n: int = 1, unit: str = "") -> None:
        self.counter(name, unit=unit).inc(n)

    def set(self, name: str, v: Any, unit: str = "") -> None:
        self.gauge(name, unit=unit).set(v)

    def set_max(self, name: str, v: float, unit: str = "") -> None:
        self.gauge(name, unit=unit).set_max(v)

    def observe(self, name: str, v: float, unit: str = "s") -> None:
        self.histogram(name, unit=unit).observe(v)

    # -- read paths ----------------------------------------------------
    def get(self, name: str):
        return self._m.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._m

    def names(self) -> List[str]:
        return list(self._m)

    def value(self, name: str, default: Any = None) -> Any:
        m = self._m.get(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            return m.count
        return m.value

    def remove(self, name: str) -> None:
        with self._lock:
            self._m.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for m in list(self._m.values()):
            out.update(m.snapshot())
        return out

    def to_prometheus(self,
                      labels: Optional[Mapping[str, str]] = None) -> str:
        """Prometheus text exposition (version 0.0.4) with TYPE hints."""
        lines: List[str] = []
        lab = _prom_labels(labels)
        for name in sorted(self._m):
            m = self._m[name]
            pname = _prom_name(name)
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} summary")
                for k, v in m.snapshot().items():
                    lines.extend(prometheus_lines({k: v}, labels))
                continue
            v = m.value
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            lines.append(f"# TYPE {pname} {m.kind}")
            lines.append(f"{pname}{lab} {v}")
        return "\n".join(lines) + "\n"

    def format_table(self) -> str:
        """Sorted ``name value [unit]`` lines -- what ``repro-serve
        --stats`` prints, identical across cohort/paged/cluster modes."""
        snap = self.snapshot()
        units = {}
        for name, m in self._m.items():
            if isinstance(m, Histogram):
                for k in m.snapshot():
                    units[k] = m.unit if k.endswith(("mean", "p50", "p95",
                                                    "p99")) else ""
            else:
                units[name] = m.unit
        width = max((len(k) for k in snap), default=0)
        lines = []
        for k in sorted(snap):
            v = snap[k]
            if isinstance(v, float):
                v = f"{v:.6g}"
            u = units.get(k, "")
            lines.append(f"{k:<{width}}  {v}" + (f" {u}" if u else ""))
        return "\n".join(lines)


_SCALAR = (bool, int, float)


class MetricsView(MutableMapping):
    """The legacy ``engine.metrics`` dict API over a ``Registry``.

    Scalar keys live in the registry (counters keep monotonic
    semantics: ``m["evictions"] += 1`` becomes an ``inc`` by the
    delta); everything else -- batching strings, the plan_page_table
    dict, the interleave/token_times ring logs -- lives in a side
    ``objects`` table.  ``dict(engine.metrics)`` and every ``.get``
    site in benchmarks/ and launch/ behave exactly as before."""

    def __init__(self, registry: Registry,
                 objects: Optional[Dict[str, Any]] = None) -> None:
        self.registry = registry
        self.objects: Dict[str, Any] = dict(objects or {})

    def __getitem__(self, key: str) -> Any:
        if key in self.registry:
            return self.registry.value(key)
        if key in self.objects:
            return self.objects[key]
        raise KeyError(key)

    def __setitem__(self, key: str, value: Any) -> None:
        m = self.registry.get(key)
        if m is not None:
            if isinstance(m, Counter):
                if not isinstance(value, _SCALAR):
                    raise TypeError(f"counter {key!r} takes numbers")
                m.inc(int(value) - m.value)  # += path; negative raises
            elif isinstance(m, Gauge):
                m.set(value)
            else:
                raise TypeError(f"cannot assign histogram {key!r}")
            return
        if isinstance(value, _SCALAR) and not isinstance(value, bool):
            self.registry.set(key, value)
        else:
            self.objects[key] = value

    def __delitem__(self, key: str) -> None:
        if key in self.registry:
            self.registry.remove(key)
        else:
            del self.objects[key]

    def __iter__(self) -> Iterator[str]:
        seen = set()
        for k in self.registry.names():
            seen.add(k)
            yield k
        for k in self.objects:
            if k not in seen:
                yield k

    def __len__(self) -> int:
        return len(set(self.registry.names()) | set(self.objects))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"MetricsView({dict(self)!r})"
