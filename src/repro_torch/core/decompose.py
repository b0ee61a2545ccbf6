"""Cache-conscious domain decomposition (paper §2.1), a copy of
``repro.core.decompose``: Algorithm 1 (``validate_np``), the §2.1.1
search for the optimal number of partitions (``find_optimal_np``), the
phi footprint estimators of §2.1.2 (``phi_simple``, ``phi_conservative``),
the mesh-level phi, the SMEM-level phi the tile planner searches with
(``make_phi_smem``, the counterpart of the reference's ``make_phi_tpu``),
and the run-time ``Decomposer``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from repro_torch.core.distribution import CompositeDomain, Distribution
from repro_torch.core.hierarchy import MemoryLevel

PhiFn = Callable[[int, Distribution, int], float]


def phi_simple(cache_line_size: int, dist: Distribution, np_: int) -> float:
    """phi_s: elementSize x floor(avgPartitionSize + 0.5) bytes."""
    del cache_line_size
    return dist.get_element_size() * math.floor(
        dist.get_average_partition_size(np_) + 0.5)


def phi_conservative(cache_line_size: int, dist: Distribution,
                     np_: int) -> float:
    """phi_c: the first dimension rounded to cache lines, plus one line a
    row for misalignment, as the paper's §2.1.2 worked example computes it
    (first-dimension size in elements; Table 2's restatement in bytes
    contradicts the example's 98304 bytes for 1024^2 at np=256):

      phi_c = lineSize * (avgPartSize*elemSize / avgFirstDim)
                       * (ceil(avgFirstDim / lineSize) + 1)
    """
    first_dim = dist.get_average_first_dim_size(np_)
    if first_dim <= 0:
        return phi_simple(cache_line_size, dist, np_)
    part_bytes = dist.get_average_partition_size(np_) * dist.get_element_size()
    rows_bytes = part_bytes / first_dim  # bytes "per unit of first dim"
    lines_per_row = math.ceil(first_dim / cache_line_size) + 1
    return cache_line_size * rows_bytes * lines_per_row


def make_phi_mesh(granule_bytes: Optional[int] = None,
                  overhead: float = 1.0) -> PhiFn:
    """Mesh-level footprint estimator: one device's shard of a logical
    tensor, rounded up to the sharding granule, scaled by ``overhead`` for
    transient copies the runtime keeps beside the resident shard."""

    def phi_mesh(cache_line_size: int, dist: Distribution, np_: int) -> float:
        g = max(1, granule_bytes or cache_line_size or 1)
        shard = dist.get_element_size() * dist.get_average_partition_size(np_)
        return overhead * math.ceil(shard / g) * g

    return phi_mesh


def make_phi_smem(vec_bytes: int = 16, buffering: int = 1) -> PhiFn:
    """SMEM-level footprint estimator: the counterpart of ``make_phi_tpu``.

    A partition staged in one block's shared memory occupies its
    contiguous dim rounded up to whole ``vec_bytes`` vectors (a thread
    loads 16 bytes at a time), times its other dims, with no pad of the
    other dims (shared memory has no second-minor tile, unlike Mosaic's
    (8, 128) layout).  ``buffering`` is the number of copies the kernel
    keeps: the port's kernels stage each tile once (1), where Pallas
    double-buffers every block (2).
    """

    def phi_smem(cache_line_size: int, dist: Distribution,
                 np_: int) -> float:
        del cache_line_size
        first = max(1.0, dist.get_average_first_dim_size(np_))
        other = dist.get_average_partition_size(np_) / first
        row = math.ceil(first * dist.get_element_size() / vec_bytes) \
            * vec_bytes
        return float(buffering * row * math.ceil(other))

    return phi_smem


def validate_np(
    tcl_per_core: int,
    cache_line_size: int,
    dists: Sequence[Distribution],
    np_: int,
    phi: PhiFn = phi_simple,
) -> int:
    """Paper Algorithm 1. Returns 1 (valid), 0 (try larger), -1 (hopeless)."""
    total_partition_size = 0.0
    for dist in dists:
        status = dist.validate(np_)
        if status <= 0:
            return status
        total_partition_size += phi(cache_line_size, dist, np_)
    return 1 if total_partition_size <= tcl_per_core else 0


class NoValidDecomposition(Exception):
    pass


def _next_structurally_valid(
    dists: Sequence[Distribution], np_: int, limit: int
) -> Optional[int]:
    """Smallest np' >= np_ whose structural validation is not 0 for every
    distribution; None if a -1 is hit or the limit is passed."""
    cand = np_
    while cand <= limit:
        worst = 1
        for d in dists:
            s = d.validate(cand)
            if s < 0:
                return None
            worst = min(worst, s)
        if worst > 0:
            return cand
        cand += 1
    return None


def find_optimal_np(
    tcl_per_core: int,
    cache_line_size: int,
    domain: Sequence[Distribution] | CompositeDomain,
    n_workers: int,
    phi: PhiFn = phi_simple,
    max_np: int = 1 << 30,
) -> int:
    """Binary search of §2.1.1: start at ``n_workers`` and double until a
    valid solution appears, then narrow to the *smallest* valid np -- the
    largest partition that still fits the TCL."""
    dists = list(domain)
    np_ = max(1, n_workers)

    # Phase 1: exponential growth, clamped so max_np itself is probed.
    hi: Optional[int] = None
    cand = np_
    while cand <= max_np:
        status = validate_np(tcl_per_core, cache_line_size, dists, cand, phi)
        if status < 0:
            raise NoValidDecomposition(
                f"no decomposition with np >= {np_} fits TCL={tcl_per_core}"
            )
        if status == 1:
            hi = cand
            break
        if cand == max_np:
            break
        cand = min(cand * 2, max_np)
    if hi is None:
        raise NoValidDecomposition(
            f"no valid np found in [{np_}, {max_np}] for TCL={tcl_per_core}"
        )

    # Phase 2: the fit is monotone over structurally valid values, so
    # binary-search the smallest valid np in [n_workers, hi].
    best = hi
    lo_s, hi_s = max(1, n_workers), hi
    while lo_s < hi_s:
        mid = (lo_s + hi_s) // 2
        probe = _next_structurally_valid(dists, mid, hi)
        if probe is None or probe >= hi:
            ok, cand = True, hi
        else:
            ok = validate_np(tcl_per_core, cache_line_size, dists, probe,
                             phi) == 1
            cand = probe
        if ok:
            best = min(best, cand)
            hi_s = mid
        else:
            lo_s = probe + 1
    return best


@dataclass
class DecompositionPlan:
    """Result of the cache-conscious decomposition of one composite domain."""

    np: int                       # partitions per sub-domain
    tcl_bytes: int                # TCL_PER_CORE used
    cache_line_size: int
    partition_bytes: float        # estimated footprint of one partition
    regions: List[List[tuple]]    # per sub-domain: list of index regions
    strategy: str = "cache_conscious"

    @property
    def n_partitions(self) -> int:
        return self.np


class Decomposer:
    """Run-time cache-conscious decomposer (the paper's contribution).

    Decomposes composite domains so each composite partition fits the TCL
    per core.  ``tcl`` names a level of ``hierarchy`` or gives a byte
    budget.  ``strategy`` is ``"cache_conscious"`` (the paper's proposal)
    or ``"horizontal"`` (the classical baseline: np == nWorkers).
    """

    def __init__(
        self,
        hierarchy: MemoryLevel,
        tcl: str | int = "L1",
        phi: PhiFn = phi_simple,
        strategy: str = "cache_conscious",
    ) -> None:
        self.hierarchy = hierarchy
        self.phi = phi
        self.strategy = strategy
        if isinstance(tcl, int):
            self._tcl_name = None
            self.tcl_bytes = tcl
            self.cache_line = 64
            for lvl in hierarchy.cache_levels():
                self.cache_line = lvl.cache_line_size or 64
                break
        else:
            lvl = hierarchy.find(tcl)
            if lvl is None:
                raise KeyError(f"no level named {tcl!r} in hierarchy")
            self._tcl_name = tcl
            self.tcl_bytes = lvl.per_core_size()
            self.cache_line = lvl.cache_line_size or 64

    def decompose(self, domain: Sequence[Distribution] | CompositeDomain,
                  n_workers: int) -> DecompositionPlan:
        """Decompose one composite domain against this decomposer's TCL:
        ``plan_run`` with the search restricted to the TCL level (a byte
        budget gets a synthetic one-level tree named ``"TCL"``), ``np``
        read off that level's sub-plan."""
        from repro_torch.core.plan import PlanPolicy, Workload, plan_run

        dists = list(domain)
        if self._tcl_name is not None:
            hierarchy, tcl_name = self.hierarchy, self._tcl_name
        else:
            hierarchy = MemoryLevel(
                size=self.tcl_bytes, siblings=[[0]],
                cache_line_size=self.cache_line, child=None, name="TCL")
            tcl_name = "TCL"
        hp = plan_run(
            hierarchy,
            Workload(domain=tuple(dists)),
            PlanPolicy(strategy=self.strategy, n_workers=n_workers,
                       cache_phi=self.phi, tcl=tcl_name),
        )
        sub = hp.level(tcl_name)
        return DecompositionPlan(
            np=sub.np,
            tcl_bytes=self.tcl_bytes,
            cache_line_size=self.cache_line,
            partition_bytes=sub.partition_bytes,
            regions=[d.partition(sub.np) for d in dists],
            strategy=self.strategy,
        )
