"""Task scheduling for cache-consciously decomposed computations (paper
§2.2), a copy of ``repro.core.schedule``.

  * **Contiguous Clustering (CC)**: worker ``i`` of ``n`` receives the
    contiguous task range ``[i*m/n, (i+1)*m/n)``; when ``m`` is not a
    multiple of ``n`` the first ``m mod n`` workers receive one extra task
    (§2.2.1, Fig. 4).
  * **Sibling Round-Robin Clustering (SRRC)**: task clusters sized by the
    LLC/TCL ratio are dealt round-robin to groups of workers sharing an
    LLC, and within a cluster round-robin to the group's workers; the
    remainder clusters and the trailing tasks form one *CC cluster*
    scheduled with CC across all workers (§2.2.2, Figs. 5-6).

Both are synchronization-free (§2.4): a worker's index set is computed
from its rank alone, in pure integer arithmetic over the shared task
vector.  ``grid_order`` and ``ring_stream_order`` are the same two orders
over a kernel grid and over a ring of devices.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple


def cc_range(rank: int, n_workers: int, n_tasks: int) -> Tuple[int, int]:
    """[start, stop) of the contiguous task range of ``rank`` under CC."""
    base, rem = divmod(n_tasks, n_workers)
    start = rank * base + min(rank, rem)
    stop = start + base + (1 if rank < rem else 0)
    return start, stop


def cc_worker_tasks(rank: int, n_workers: int, n_tasks: int) -> List[int]:
    start, stop = cc_range(rank, n_workers, n_tasks)
    return list(range(start, stop))


def cc_schedule(n_workers: int, n_tasks: int) -> List[List[int]]:
    return [cc_worker_tasks(r, n_workers, n_tasks) for r in range(n_workers)]


def srrc_cluster_size(llc_size: int, tcl_size: int, cores_per_llc: int) -> int:
    """clusterSize = LLC/TCL + (cores(LLC) - (LLC/TCL mod cores(LLC))).

    The second term is applied only when a remainder exists (LLC/TCL
    padded up to the next multiple of cores(LLC)), the paper's stated
    intent, without a gratuitous +cores(LLC) when the ratio divides.
    """
    s = max(1, llc_size // max(1, tcl_size))
    c = max(1, cores_per_llc)
    return s + ((c - (s % c)) % c)


@dataclass
class SRRCSchedule:
    """Materialized SRRC assignment: ``worker_groups[g]`` lists the ranks
    of group ``g`` (one group per LLC copy), ``assignment[w]`` the ordered
    task list of worker ``w``."""

    cluster_size: int
    n_full_clusters: int        # clusters dealt round-robin to groups
    cc_cluster_start: int       # first task index of the merged CC cluster
    worker_groups: List[List[int]]
    assignment: List[List[int]]


def _srrc_shape(n_tasks: int, llc_size: int, tcl_size: int,
                groups: List[List[int]]) -> Tuple[int, int]:
    """The cluster size and the number of clusters dealt round-robin."""
    csize = srrc_cluster_size(llc_size, tcl_size, max(len(g) for g in groups))
    n_c = n_tasks // csize                      # clusters that can be formed
    return csize, n_c - (n_c % len(groups))


def srrc_schedule(
    n_tasks: int,
    llc_size: int,
    tcl_size: int,
    worker_groups: Sequence[Sequence[int]],
) -> SRRCSchedule:
    """Build the SRRC schedule (§2.2.2).  ``worker_groups`` partitions the
    worker ranks into groups whose cores share an LLC (§2.3's affinity
    keeps the workers there)."""
    groups = [list(g) for g in worker_groups]
    n_w = len(groups)
    csize, n_rr = _srrc_shape(n_tasks, llc_size, tcl_size, groups)
    cc_start = n_rr * csize                     # remainder + tail -> CC

    n_workers = sum(len(g) for g in groups)
    assignment: List[List[int]] = [[] for _ in range(n_workers)]
    # Cluster j -> group (j mod n_w); within it, round-robin (Fig. 6).
    for j in range(n_rr):
        group = groups[j % n_w]
        base = j * csize
        for t in range(csize):
            assignment[group[t % len(group)]].append(base + t)
    # The merged CC cluster over all workers.
    tail = n_tasks - cc_start
    if tail > 0:
        for rank in range(n_workers):
            lo, hi = cc_range(rank, n_workers, tail)
            assignment[rank].extend(range(cc_start + lo, cc_start + hi))

    return SRRCSchedule(
        cluster_size=csize,
        n_full_clusters=n_rr,
        cc_cluster_start=cc_start,
        worker_groups=groups,
        assignment=assignment,
    )


def srrc_worker_tasks(
    rank: int,
    n_tasks: int,
    llc_size: int,
    tcl_size: int,
    worker_groups: Sequence[Sequence[int]],
) -> Iterator[int]:
    """One worker's SRRC index stream, computed from ``rank`` alone with
    two loops (across its group's clusters, within a cluster), without
    materializing other workers' assignments (§2.4)."""
    groups = [list(g) for g in worker_groups]
    n_w = len(groups)
    gid = next(i for i, g in enumerate(groups) if rank in g)
    pos = groups[gid].index(rank)
    gsize = len(groups[gid])
    csize, n_rr = _srrc_shape(n_tasks, llc_size, tcl_size, groups)
    for j in range(gid, n_rr, n_w):
        base = j * csize
        for t in range(pos, csize, gsize):
            yield base + t
    cc_start = n_rr * csize
    tail = n_tasks - cc_start
    if tail > 0:
        lo, hi = cc_range(rank, sum(len(g) for g in groups), tail)
        yield from range(cc_start + lo, cc_start + hi)


def lowest_level_shared_cache_groups(hierarchy) -> List[List[int]]:
    """Lowest-Level-Shared-Cache affinity (§2.3): workers may float among
    the cores under their lowest shared cache, so the groups are that
    level's sibling groups (one a cache copy)."""
    lvl = hierarchy.lowest_shared_cache()
    if lvl is None:
        return [[c] for c in range(hierarchy.n_cores)]
    return [list(g) for g in lvl.siblings]


def ring_stream_order(p: int, strategy: str = "cc") -> List[Tuple[int, ...]]:
    """Per-step chunk-owner offsets for streaming a ``p``-chunk ring, the
    interconnect's CC/SRRC choice.  At step ``s`` a device holds the chunk
    first owned by ``(rank - offset) % p``.

      * ``cc``: one direction, ``[(0,), (1,), ..., (p-1,)]``;
      * ``srrc``: both directions at once, ``[(s, -s mod p) for s]``:
        each step consumes the forward half-chunk of ``rank - s`` and the
        backward half-chunk of ``rank + s``, alternating sides like
        §2.2.2's serpentine.

    Each direction covers all ``p`` offsets once, one hop a step.
    """
    if p < 1:
        raise ValueError(f"ring needs p >= 1, got {p}")
    if strategy == "cc":
        return [(s,) for s in range(p)]
    if strategy == "srrc":
        return [(s, (-s) % p) for s in range(p)]
    raise ValueError(f"unknown strategy {strategy!r} (one of 'cc', 'srrc')")


def grid_order(grid: Tuple[int, ...],
               strategy: str = "cc") -> List[Tuple[int, ...]]:
    """Sequential visit order of a kernel grid under a strategy.

    ``cc``: row-major (last dim innermost), contiguous output tiles with
    the reduction innermost.  ``srrc``: serpentine over the leading dim,
    so consecutive tasks share an operand block.
    """
    cells = list(itertools.product(*[range(g) for g in grid]))
    if strategy == "cc" or len(grid) < 2:
        return cells
    if strategy == "srrc":
        tail = list(itertools.product(*[range(g) for g in grid[1:]]))
        out = []
        for i in range(grid[0]):
            out.extend((i,) + t for t in (tail[::-1] if i % 2 else tail))
        return out
    raise ValueError(f"unknown strategy {strategy!r}")
