"""The port's tuning artifact: measured block winners the planner consults.

A copy of ``repro.tune.cache`` with the same JSON schema and merge rules.
Each entry records one sweep winner keyed by

  ``(kernel, arch, workload-shape bucket, hw fingerprint)``

where the bucket rounds every shape dim to its power-of-two ceiling
(nearby shapes share a winner) and the fingerprint pins the measurement to
the device it was taken on: ``cuda:<device name>`` for timings on a card,
``cpu:<machine>`` for a CPU sweep, which therefore never matches on a card.
A fingerprint mismatch falls back to the analytic choice.

Precedence is ``analytic < tuned``: the analytic plan is always computed
(it is the sweep centre and the fallback), and a matching tuned entry
replaces only the block extents, after re-passing the planner's own
working-set filter.

The artifact is the port's own: ``$REPRO_TORCH_TUNING`` if set, else
``experiments/tuning_torch.json`` (not committed).  The JAX package's
``experiments/tuning.json`` is never read or written here.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "TUNING_ENV",
    "TuningEntry",
    "bucket_attention",
    "bucket_matmul",
    "bucket_paged",
    "bucket_ssd",
    "entry_key",
    "hw_fingerprint",
    "load_tuning",
    "lookup_tuned",
    "record_tuned",
    "tuning_path",
]

#: Env var overriding the tuning artifact path (tests and ``chip_smoke.py``
#: point it at a file of their own).
TUNING_ENV = "REPRO_TORCH_TUNING"


def tuning_path() -> str:
    override = os.environ.get(TUNING_ENV)
    if override:
        return override
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, "experiments", "tuning_torch.json")


def hw_fingerprint(device=None) -> str:
    """``cuda:<device name>`` or ``cpu:<machine>``: the device timings run
    on.  ``device=None`` is the device the port's entry points default to
    on this machine (the card if there is one), which is what the planner
    looks entries up under."""
    import platform

    import torch

    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{platform.machine() or 'unknown'}"


# ---------------------------------------------------------------------------
# Workload-shape buckets
# ---------------------------------------------------------------------------


def _p2(x: int) -> int:
    x = max(1, int(x))
    return 1 << (x - 1).bit_length()


def bucket_matmul(m: int, k: int, n: int, dtype_bytes: int = 2) -> str:
    return f"m{_p2(m)}k{_p2(k)}n{_p2(n)}b{dtype_bytes}"


def bucket_attention(q_len: int, kv_len: int, head_dim: int,
                     dtype_bytes: int = 2) -> str:
    return f"q{_p2(q_len)}kv{_p2(kv_len)}d{_p2(head_dim)}b{dtype_bytes}"


def bucket_paged(tok_bytes: int, max_tokens: int) -> str:
    """Decode page search bucket: the per-shard token footprint and the
    resident-token bound are the only shape inputs of ``phi_page``."""
    return f"tok{_p2(tok_bytes)}len{_p2(max_tokens)}"


def bucket_ssd(seq_len: int, n_heads: int, head_dim: int,
               state_dim: int, dtype_bytes: int = 2) -> str:
    return (f"s{_p2(seq_len)}h{_p2(n_heads)}p{_p2(head_dim)}"
            f"n{_p2(state_dim)}b{dtype_bytes}")


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TuningEntry:
    """One sweep winner.

    ``block`` holds the kernel-specific tuned extents (``bm/bk/bn`` for
    matmul, ``block_q/block_kv`` for attention, ``page_tokens`` for paged,
    ``chunk`` for ssd); ``analytic_block`` the sweep center it perturbed;
    ``median_us``/``analytic_us`` the measured medians and ``speedup``
    their ratio (> 1 means the tuned block beat the analytic center).
    """

    kernel: str
    arch: str
    bucket: str
    fingerprint: str
    block: Mapping[str, int]
    analytic_block: Mapping[str, int] = field(default_factory=dict)
    median_us: float = 0.0
    analytic_us: float = 0.0
    speedup: float = 1.0
    workload: Mapping[str, Any] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return entry_key(self.kernel, self.arch, self.bucket,
                         self.fingerprint)


def entry_key(kernel: str, arch: str, bucket: str, fingerprint: str) -> str:
    return f"{kernel}|{arch}|{bucket}|{fingerprint}"


#: path -> ((mtime_ns, size) | None, parsed entries) -- stat-keyed so a
#: rewrite (a sweep running in-process) is picked up without manual
#: invalidation.
_TUNE_CACHE: Dict[str, Tuple[Optional[Tuple[int, int]],
                             Dict[str, Dict[str, Any]]]] = {}

_ENTRY_FIELDS = ("kernel", "arch", "bucket", "fingerprint", "block",
                 "analytic_block", "median_us", "analytic_us", "speedup",
                 "workload")


def load_tuning(path: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """``{key: entry-dict}`` from the tuning artifact (empty on any read or
    parse problem -- tuning is advisory, never a hard dep)."""
    path = path or tuning_path()
    try:
        st = os.stat(path)
        sig: Optional[Tuple[int, int]] = (st.st_mtime_ns, st.st_size)
    except OSError:
        sig = None
    cached = _TUNE_CACHE.get(path)
    if cached is not None and cached[0] == sig:
        return cached[1]
    out: Dict[str, Dict[str, Any]] = {}
    if sig is not None:
        try:
            with open(path) as f:
                data = json.load(f)
            entries = data.get("entries", {})
            if isinstance(entries, dict):
                for key, e in entries.items():
                    if isinstance(e, dict) and isinstance(
                            e.get("block"), dict):
                        out[key] = e
        except (OSError, ValueError):
            out = {}
    _TUNE_CACHE[path] = (sig, out)
    return out


def lookup_tuned(kernel: str, arch: str, bucket: str,
                 fingerprint: Optional[str] = None,
                 path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The tuned entry for one (kernel, arch, bucket) on THIS hardware, or
    None (unknown key, fingerprint mismatch, missing artifact -- every miss
    means the analytic choice stands)."""
    fp = fingerprint if fingerprint is not None else hw_fingerprint()
    return load_tuning(path).get(entry_key(kernel, arch, bucket, fp))


def record_tuned(entries: List[TuningEntry],
                 path: Optional[str] = None) -> str:
    """Merge sweep winners into the artifact (existing entries for other
    keys survive -- the artifact accumulates across partial sweeps)."""
    path = path or tuning_path()
    existing: Dict[str, Any] = {}
    try:
        with open(path) as f:
            existing = json.load(f)
    except (OSError, ValueError):
        existing = {}
    merged = existing.get("entries")
    if not isinstance(merged, dict):
        merged = {}
    for e in entries:
        d = asdict(e)
        merged[e.key] = {f: d[f] for f in _ENTRY_FIELDS}
    out = {
        "_meta": {
            "source": "repro_torch.tune.sweep "
                      "(python -m repro_torch.launch.tune)",
            "note": "block winners of the neighborhood sweep around the "
                    "port planner's analytic tiles; consulted by "
                    "core.plan/_plan_tile_level, core.autotile."
                    "plan_attention, core.plan/_plan_page_level and "
                    "models.mamba2.choose_chunk when (kernel, arch, "
                    "bucket, fingerprint) matches; precedence "
                    "analytic < tuned",
        },
        "entries": {k: merged[k] for k in sorted(merged)},
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return path
