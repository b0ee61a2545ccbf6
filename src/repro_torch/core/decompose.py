"""Algorithm 1 (``validate_np``), the §2.1.1 search for the optimal number
of partitions (``find_optimal_np``), the mesh-level phi, and the SMEM-level
phi the tile planner searches with (``make_phi_smem``, the counterpart of
``repro.core.decompose.make_phi_tpu``) -- a copy of the part of
``repro.core.decompose`` the port's planner walks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

from repro_torch.core.distribution import Distribution

PhiFn = Callable[[int, Distribution, int], float]


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
    phi: PhiFn,
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
    domain: Sequence[Distribution],
    n_workers: int,
    phi: PhiFn,
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
