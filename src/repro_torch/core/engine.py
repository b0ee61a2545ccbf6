"""Synchronization-free execution engine (paper §2.4), a copy of
``repro.core.engine``.

The decomposition's tasks sit contiguously in one shared vector; each
worker computes its own index set from its rank and the schedule and
walks the shared vector without synchronization, since the schedules give
every worker a disjoint, locally computable set.

This is host code: the workers are OS threads, and they run in parallel
only where a task's body releases the interpreter lock (numpy's loops
over large arrays do).  The engine creates no tensor and chooses no
device; the computation a caller hands to ``run`` carries its own data.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core.decompose import (Decomposer, DecompositionPlan,
                                        phi_simple)
from repro_torch.core.distribution import CompositeDomain
from repro_torch.core.hierarchy import MemoryLevel
from repro_torch.core.schedule import (cc_worker_tasks,
                                       lowest_level_shared_cache_groups,
                                       srrc_schedule)

# A task is one computation instance with its partition: by default the
# tuple of per-sub-domain regions, handed to a user callable.
Task = Any
Computation = Callable[..., Any]


@dataclass
class StageTimes:
    """Per-stage wall seconds, the breakdown of the paper's Fig. 10."""

    decomposition: float = 0.0
    scheduling: float = 0.0
    execution: float = 0.0
    reduction: float = 0.0

    @property
    def total(self) -> float:
        return (self.decomposition + self.scheduling + self.execution
                + self.reduction)


@dataclass
class RunResult:
    results: List[Any]
    times: StageTimes
    n_tasks: int
    np: int


class Engine:
    """Decompose -> schedule -> execute -> reduce, with per-stage timing.

    ``schedule`` is ``"cc"`` or ``"srrc"``; ``strategy`` is
    ``"cache_conscious"`` (the paper's proposal) or ``"horizontal"`` (the
    classical baseline).  ``parallel=False`` runs the workers' index sets
    one after another on the calling thread.
    """

    def __init__(
        self,
        hierarchy: MemoryLevel,
        n_workers: int,
        tcl: str | int = "L1",
        schedule: str = "cc",
        strategy: str = "cache_conscious",
        phi=None,
        parallel: bool = True,
    ) -> None:
        self.hierarchy = hierarchy
        self.n_workers = n_workers
        self.schedule = schedule
        self.parallel = parallel
        self.decomposer = Decomposer(hierarchy, tcl=tcl,
                                     phi=phi or phi_simple,
                                     strategy=strategy)

    def run(
        self,
        domain: CompositeDomain | Sequence,
        compute: Computation,
        make_tasks: Optional[Callable[[DecompositionPlan], List[Task]]] = None,
        reduce_fn: Optional[Callable[[List[Any]], Any]] = None,
    ) -> RunResult:
        """Execute ``compute`` over the decomposed ``domain``.

        ``make_tasks(plan)`` builds the shared task vector from the plan
        (default: the per-sub-domain regions zipped); ``compute(task)`` is
        the user's computation; ``reduce_fn`` merges the ordered per-task
        results (identity by default).
        """
        times = StageTimes()

        t0 = time.perf_counter()
        plan = self.decomposer.decompose(domain, self.n_workers)
        times.decomposition = time.perf_counter() - t0

        t0 = time.perf_counter()
        if make_tasks is None:
            tasks: List[Task] = list(zip(*plan.regions))
        else:
            tasks = make_tasks(plan)
        per_worker = self._assign(len(tasks))
        times.scheduling = time.perf_counter() - t0

        t0 = time.perf_counter()
        results: List[Any] = [None] * len(tasks)

        def work(rank: int) -> None:
            # Disjoint indices into shared vectors: no synchronization.
            for idx in per_worker[rank]:
                results[idx] = compute(tasks[idx])

        if self.parallel and self.n_workers > 1:
            errors: List[Exception] = []

            def guarded(rank: int) -> None:
                try:
                    work(rank)
                except Exception as exc:  # re-raised after the join
                    errors.append(exc)

            threads = [threading.Thread(target=guarded, args=(r,))
                       for r in range(self.n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        else:
            for r in range(self.n_workers):
                work(r)
        times.execution = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = results if reduce_fn is None else reduce_fn(results)
        times.reduction = time.perf_counter() - t0

        return RunResult(
            results=out if isinstance(out, list) else [out],
            times=times,
            n_tasks=len(tasks),
            np=plan.np,
        )

    def _assign(self, n_tasks: int) -> List[List[int]]:
        if self.schedule == "cc":
            return [cc_worker_tasks(r, self.n_workers, n_tasks)
                    for r in range(self.n_workers)]
        if self.schedule == "srrc":
            llc = self.hierarchy.llc()
            llc_size = (llc.size if llc is not None
                        else self.decomposer.tcl_bytes)
            return srrc_schedule(n_tasks, llc_size,
                                 self.decomposer.tcl_bytes,
                                 self._worker_groups()).assignment
        raise ValueError(f"unknown schedule {self.schedule!r}")

    def _worker_groups(self) -> List[List[int]]:
        """Map workers onto the lowest shared cache's core groups (§2.3):
        ranks are dealt to the groups in proportion to their core counts,
        leftovers to the last group."""
        core_groups = lowest_level_shared_cache_groups(self.hierarchy)
        n_cores = sum(len(g) for g in core_groups)
        groups: List[List[int]] = []
        rank = 0
        for g in core_groups:
            take = max(1, round(self.n_workers * len(g) / n_cores))
            take = min(take, self.n_workers - rank)
            if take <= 0:
                continue
            groups.append(list(range(rank, rank + take)))
            rank += take
        while rank < self.n_workers:
            groups[-1].append(rank)
            rank += 1
        return [g for g in groups if g]
