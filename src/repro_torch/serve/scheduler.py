"""The serving request record and the cohort engine's scheduler (the port
of ``repro.serve.scheduler``): admission, growth and eviction under the
planned KV budget.

Pure bookkeeping -- no tensors anywhere -- so the admission invariant is
directly property-testable: **allocated KV bytes never exceed the planned
budget**, where allocated bytes are what the contiguous cache buffers pin
(pages x page_bytes per slot, plus each sequence's token-free state).

The schedulable unit is a *cohort*: requests admitted together with the
same prompt shape, decoded as one batch.  The family decode step carries
one position for the whole batch (``cache["pos"]``), so a batch must be
position-homogeneous; mixed prompt lengths are served by running several
cohorts concurrently, one decode step per cohort per engine tick, with
prefills of newly admitted cohorts in between.

Rules:

  * **admit**   FIFO by head-of-queue; a cohort is the head request plus
    every queued request with the same group key (up to ``max_slots``).
    Admitted iff ``allocated + sum_r(pages(admit_tokens_r) * page_bytes +
    state_r) <= budget`` -- ``admit_tokens`` is prompt + first decode page
    for growable caches, the full window-clamped capacity for fixed-extent
    (ring) buffers that allocate up front.
  * **reserve** growing a cohort's capacity by one page costs
    ``slots * page_bytes``; refused (False) when it would cross the
    budget -- the engine then evicts the youngest other cohort
    (recompute preemption: its unfinished requests requeue at the
    *front*, keeping FIFO order) and retries.
  * **release** pages free only when the whole cohort retires (the
    buffers are batch-shared) or when the engine compacts the batch to the
    surviving slots (``shrink_slots``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Hashable, List, Optional, Tuple

from repro_torch.serve.kvcache import PageSpec


@dataclass
class Request:
    """One sequence to serve. ``features`` is the engine's opaque prompt
    payload (``{"tokens": ...}``; a vlm request's ``"embeds"`` and
    ``"positions_3d"``; an enc-dec request's ``"enc_embeds"``); ``rid``
    orders preemption (older requests outrank younger ones);
    ``state_bytes`` is its token-free cache cost
    (``serve.kvcache.request_state_bytes``: the hybrid's conv and SSM
    state, enc-dec's cross K/V, 0 for the dense family); ``group`` keys
    cohort compatibility, ``(prompt_len, enc_len)`` as the engine sets it.

    ``admit_tokens`` is the KV token extent one slot PINS at admission --
    prompt + first decode page for growable caches (the default), the full
    window-clamped capacity for fixed-extent buffers (sliding-window rings
    allocate up front and never grow), so the scheduler's accounting
    matches the allocation."""

    rid: int
    prompt_len: int
    max_new: int
    state_bytes: int = 0
    features: Any = None
    group: Hashable = None
    admit_tokens: Optional[int] = None

    def __post_init__(self):
        if self.group is None:
            self.group = (self.prompt_len,)
        self.max_new = max(1, int(self.max_new))
        if self.admit_tokens is None:
            self.admit_tokens = self.prompt_len + 1


@dataclass
class _Cohort:
    cid: int
    reqs: List[Request]
    pages_per_slot: int
    done: set = field(default_factory=set)

    @property
    def slots(self) -> int:
        return len(self.reqs)


class ServeScheduler:
    """Admission control for the cohort engine (see module docstring)."""

    def __init__(self, budget_bytes: int, page: PageSpec,
                 max_slots: int = 8):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive: {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.page = page
        self.max_slots = max(1, max_slots)
        self.pending: Deque[Request] = deque()
        self._cohorts: Dict[int, _Cohort] = {}
        self._next_cid = 0
        self.peak_bytes = 0
        self.n_evictions = 0
        # Cumulative page flow: every page a slot pins is counted once in
        # ``pages_allocated`` and credited back in ``pages_released`` when
        # it frees, compaction (``shrink_slots``) included.  Invariant:
        # allocated - released == resident.
        self.pages_allocated = 0
        self.pages_released = 0

    # ------------------------------------------------------------- accounting
    def _cohort_bytes(self, c: _Cohort) -> int:
        per_slot = c.pages_per_slot * self.page.page_bytes
        return sum(per_slot + r.state_bytes for r in c.reqs)

    @property
    def allocated_bytes(self) -> int:
        return sum(self._cohort_bytes(c) for c in self._cohorts.values())

    @property
    def allocated_pages(self) -> int:
        """Resident pages across all live cohorts (slots x pages each)."""
        return sum(c.pages_per_slot * c.slots for c in self._cohorts.values())

    def assert_reconciled(self) -> None:
        """Page-accounting invariant: the cumulative flow counters must
        reproduce the resident page count exactly."""
        flow = self.pages_allocated - self.pages_released
        if flow != self.allocated_pages:
            raise AssertionError(
                f"page accounting leak: allocated {self.pages_allocated} - "
                f"released {self.pages_released} = {flow} != resident "
                f"{self.allocated_pages}")

    def _note_peak(self) -> None:
        self.peak_bytes = max(self.peak_bytes, self.allocated_bytes)

    def capacity_tokens(self, cid: int) -> int:
        return self.page.capacity(self._cohorts[cid].pages_per_slot)

    def has_work(self) -> bool:
        return bool(self.pending) or bool(self._cohorts)

    def running(self) -> List[int]:
        return list(self._cohorts)

    # --------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _admission_cost(self, reqs: List[Request], pages: int) -> int:
        return sum(pages * self.page.page_bytes + r.state_bytes for r in reqs)

    def admit(self) -> List[Tuple[int, List[Request]]]:
        """Admit pending cohorts while the head of the queue fits.  Returns
        ``[(cohort_id, requests), ...]`` admitted this call.  Raises when a
        lone head request can never fit an empty budget (it would starve
        the queue forever)."""
        admitted: List[Tuple[int, List[Request]]] = []
        while self.pending:
            head = self.pending[0]
            batch = [r for r in self.pending
                     if r.group == head.group][:self.max_slots]
            # Every slot shares the cohort capacity: the widest admission
            # need sets the page count.
            pages = max(self.page.pages_for(r.admit_tokens) for r in batch)
            cost = self._admission_cost(batch, pages)
            if self.allocated_bytes + cost > self.budget_bytes:
                if not self._cohorts and len(batch) == 1:
                    raise ValueError(
                        f"request {head.rid} needs {cost} KV bytes; the "
                        f"planned budget is {self.budget_bytes} -- raise "
                        f"kv_budget_bytes or shorten the prompt")
                if not self._cohorts and len(batch) > 1:
                    # Shrink the cohort until it fits before giving up.
                    while len(batch) > 1 and self.allocated_bytes + cost \
                            > self.budget_bytes:
                        batch = batch[:-1]
                        cost = self._admission_cost(batch, pages)
                    if self.allocated_bytes + cost > self.budget_bytes:
                        raise ValueError(
                            f"request {head.rid} alone exceeds the planned "
                            f"KV budget {self.budget_bytes}")
                else:
                    break               # wait for running cohorts to retire
            ids = {id(r) for r in batch}
            self.pending = deque(r for r in self.pending
                                 if id(r) not in ids)
            cid = self._next_cid
            self._next_cid += 1
            self._cohorts[cid] = _Cohort(cid=cid, reqs=batch,
                                         pages_per_slot=pages)
            self.pages_allocated += pages * len(batch)
            admitted.append((cid, batch))
            self._note_peak()
        return admitted

    # ------------------------------------------------------------------ growth
    def reserve(self, cid: int, capacity_tokens: int) -> bool:
        """Grow cohort ``cid``'s per-slot capacity to cover
        ``capacity_tokens``.  True iff the extra pages fit the budget."""
        c = self._cohorts[cid]
        new_pages = self.page.pages_for(capacity_tokens)
        delta = (new_pages - c.pages_per_slot) * c.slots * self.page.page_bytes
        if delta <= 0:
            return True
        if self.allocated_bytes + delta > self.budget_bytes:
            return False
        self.pages_allocated += (new_pages - c.pages_per_slot) * c.slots
        c.pages_per_slot = new_pages
        self._note_peak()
        return True

    # -------------------------------------------------------------- retirement
    def finish(self, cid: int, rid: int) -> bool:
        """Mark one slot finished; True (and pages released) when the whole
        cohort is done."""
        c = self._cohorts[cid]
        c.done.add(rid)
        if len(c.done) == c.slots:
            self.pages_released += c.pages_per_slot * c.slots
            del self._cohorts[cid]
            return True
        return False

    def shrink_slots(self, cid: int, keep_rids: List[int]) -> None:
        """Compact a cohort to ``keep_rids`` (the engine sliced the batch
        axis); the dropped slots' pages and state free immediately and are
        credited back to the flow counters."""
        c = self._cohorts[cid]
        keep = set(keep_rids)
        dropped = sum(1 for r in c.reqs if r.rid not in keep)
        self.pages_released += c.pages_per_slot * dropped
        c.reqs = [r for r in c.reqs if r.rid in keep]
        c.done = {rid for rid in c.done if rid in keep}
        if not c.reqs:
            del self._cohorts[cid]

    def evict(self, cid: int) -> List[Request]:
        """Preempt a cohort: free everything, requeue its unfinished
        requests at the FRONT of the queue (FIFO order preserved), and
        return them (the engine re-prefills from scratch -- recompute
        preemption)."""
        c = self._cohorts.pop(cid)
        self.pages_released += c.pages_per_slot * c.slots
        revived = [r for r in c.reqs if r.rid not in c.done]
        for r in reversed(revived):
            self.pending.appendleft(r)
        self.n_evictions += 1
        return revived

    def youngest_other(self, cid: int) -> Optional[int]:
        """The eviction victim: the cohort holding the *newest work* other
        than ``cid`` (least sunk cost).  Age is the oldest original request
        id in the cohort -- rids are assigned at submission and survive
        eviction, so a previously preempted cohort that re-admitted keeps
        its seniority and is not picked again ahead of newer arrivals."""
        others = [k for k in self._cohorts if k != cid]
        if not others:
            return None
        return max(others,
                   key=lambda k: min(r.rid for r in self._cohorts[k].reqs))
