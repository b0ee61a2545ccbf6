"""The global KV page pool: plan-sized pages, per-slot tables, slot-level
admission (the port of ``repro.serve.pages`` for the dense family).

  * ``PagePool`` -- the physical pool: ``pages_total`` pages of
    ``page_plan()["page_tokens"]`` tokens each, a refcounted free list and
    cumulative alloc/release counters.  Physical page 0 is the reserved
    *null page*: empty slots' decode writes land there and nothing ever
    reads it unmasked.
  * ``PagedScheduler`` -- slot-level admission, pure python: a fixed batch
    of decode slots, FIFO admission of one request per free slot, one-page
    growth, youngest-slot recompute preemption, and sliding-window page
    reclaim.  A finished slot frees its pages at once and is backfilled by
    the next pending request mid-flight.
  * ``init_paged_cache`` / ``reset_slot`` -- the pooled cache dict the
    paged steps (``Model.decode_step_paged`` / ``prefill_chunk``) consume:
    ``pool`` (``k``/``v``, each ``(L, P, T, KV, D)``), ``table`` (the
    per-slot page table) and ``pos`` (the per-slot position vector).

Page export/install and the prefix cache's hooks wait for the prefix
slice.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.kvcache import PageSpec
from repro_torch.serve.scheduler import Request

PyTree = Any

#: Families with a per-slot paged decode path in the port.
PAGED_FAMILIES = ("dense",)


# ---------------------------------------------------------------------------
# Physical pool
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list allocator over the physical page pool.

    ``pages_total`` includes the reserved null page 0, which is never
    allocated or freed.  Every page carries a reference count (the prefix
    cache's slice will share pages; here it is 0 or 1): ``alloc`` hands
    out pages at refcount 1 and ``free`` drops it.  Freeing a page that
    holds no reference (double free, or a scheduler bug returning a page it
    never owned) raises instead of silently corrupting the free list.

    ``pages_allocated`` / ``pages_released`` count transitions (free list
    -> used and back), so ``pages_allocated - pages_released ==
    used_pages`` is an invariant ``assert_reconciled`` pins after every op.
    """

    def __init__(self, pages_total: int, obs=None, tracer=None):
        if pages_total < 2:
            raise ValueError(
                f"pages_total must be >= 2 (null page + one usable page), "
                f"got {pages_total}")
        self.pages_total = int(pages_total)
        # pop() yields ascending physical ids -- deterministic layouts.
        self._free = list(range(self.pages_total - 1, 0, -1))
        self._rc = [0] * self.pages_total
        self.pages_allocated = 0
        self.pages_released = 0
        # Observability hooks (DESIGN.md §13): the pool is the single
        # writer of the occupancy gauges the engine's stats() view, the
        # cluster router's ``free_pages`` policy and the plan-vs-actual
        # report all read; alloc/free land in the trace as instants.
        self.obs = obs
        self.tracer = tracer
        self._publish()

    def _publish(self) -> None:
        if self.obs is not None:
            self.obs.set("free_pages", self.free_pages, unit="pages")
            self.obs.set("used_pages", self.used_pages, unit="pages")
            self.obs.set_max("pool_peak_pages", self.used_pages,
                             unit="pages")

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.pages_total - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` physical pages at refcount 1, or None when the pool
        cannot hold them (never a partial grant)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for i in out:
            self._rc[i] = 1
        self.pages_allocated += n
        self._publish()
        if self.tracer is not None:
            self.tracer.instant("page_alloc",
                                args={"n": n, "free": self.free_pages})
        return out

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; a page returns to the free list
        (and counts as released) only at refcount zero."""
        for i in ids:
            if i == 0:
                raise ValueError("page 0 is the reserved null page")
            if i < 0 or i >= self.pages_total or self._rc[i] <= 0:
                raise ValueError(
                    f"double free (or free of never-allocated page) {i}")
            self._rc[i] -= 1
            if self._rc[i] == 0:
                self._free.append(i)
                self.pages_released += 1
        self._publish()
        if self.tracer is not None:
            self.tracer.instant("page_free",
                                args={"n": len(ids),
                                      "free": self.free_pages})

    def assert_reconciled(self) -> None:
        """Flow counters vs free list vs refcounts (the property tests'
        per-op pin)."""
        assert self.pages_allocated - self.pages_released == \
            self.used_pages, "page flow counters do not reconcile"
        assert len(set(self._free)) == len(self._free), \
            "free list holds a duplicate page"
        assert all(self._rc[i] == 0 for i in self._free), \
            "free list holds a referenced page"
        assert self._rc[0] == 0, "null page acquired a refcount"
        live = sum(1 for c in self._rc if c > 0)
        assert live == self.used_pages, \
            "refcounted pages do not match used pages"


# ---------------------------------------------------------------------------
# Slot-level scheduler
# ---------------------------------------------------------------------------


@dataclass
class SlotState:
    """One occupied decode slot.  ``pages`` maps logical page index ->
    physical page id, ``None`` marking a window-reclaimed page (its tokens
    fell out of the sliding window; the table keeps pointing at the null
    page and the kernel's window mask never reads them)."""

    rid: int
    req: Request
    pos: int                        # resident tokens (prompt, then +1/step)
    pages: List[Optional[int]] = field(default_factory=list)

    @property
    def live_pages(self) -> List[int]:
        return [p for p in self.pages if p is not None]


class PagedScheduler:
    """Slot-level admission under the page-pool budget (pure python).

    The schedulable unit is one SLOT of a fixed decode batch -- not a
    cohort -- so a finished sequence's pages free immediately and the slot
    is backfilled by the next pending request between decode ticks.
    Rules:

      * **admit**   FIFO: the head request takes any free slot iff the pool
        can grant its first page; the prompt's other pages are granted as
        its chunks arrive.  A lone head that can never fit an empty pool
        raises.
      * **grow**    one page at a time when the chunk front or ``pos + 1``
        crosses the slot's capacity; refusal (pool empty) makes the
        engine preempt or stall.
      * **victim**  the slot holding the newest request strictly younger
        than the grower's (least sunk cost; rids survive requeueing so a
        preempted request keeps its seniority).  A grower with no younger
        victim STALLS for the tick instead -- pages pinned, decode
        skipped -- so mutual eviction ping-pong cannot happen and the
        oldest request always progresses.
      * **reclaim** pages wholly below ``pos - window`` free immediately
        (sliding-window configs only).
    """

    def __init__(self, pool: PagePool, page: PageSpec, n_slots: int,
                 pages_per_slot: int, window: int = 0):
        self.pool = pool
        self.page = page
        self.n_slots = max(1, n_slots)
        self.pages_per_slot = max(1, pages_per_slot)
        self.window = max(0, window)
        self.slots: List[Optional[SlotState]] = [None] * self.n_slots
        self.pending: Deque[Request] = deque()

    # ----------------------------------------------------------- inventory
    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def used_pages_by_slots(self) -> int:
        return sum(len(s.live_pages) for s in self.slots if s is not None)

    # ----------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def admit(self) -> List[Tuple[int, Request, List[Optional[int]]]]:
        """Fill free slots from the queue head for CHUNKED prefill.
        Returns ``[(slot, request, logical_pages), ...]``: each slot starts
        at ``pos = 0`` with only its FIRST page allocated -- the engine
        grows it page by page ahead of the chunk front
        (``ensure_capacity(slot, upto=...)``) and window-reclaims behind
        it.  A lone head that cannot get one page of an empty pool raises.
        """
        out: List[Tuple[int, Request, List[Optional[int]]]] = []
        for slot, s in enumerate(self.slots):
            if s is not None or not self.pending:
                continue
            head = self.pending[0]
            ids = self.pool.alloc(1)
            if ids is None:
                if not any(x is not None for x in self.slots) and not out:
                    raise ValueError(
                        f"request {head.rid} needs at least 1 KV page; "
                        f"the pool holds {self.pool.pages_total - 1} -- "
                        f"raise kv_budget_bytes")
                break                     # wait for running slots to free
            self.pending.popleft()
            self.slots[slot] = SlotState(rid=head.rid, req=head, pos=0,
                                         pages=list(ids))
            out.append((slot, head, list(ids)))
        return out

    # -------------------------------------------------------------- growth
    def ensure_capacity(self, slot: int, upto: Optional[int] = None) -> bool:
        """Make room in ``slot`` for tokens up to position ``upto``
        (exclusive; default ``pos + 1`` -- one more decode token).  Grows
        page by page.  True when capacity exists or was granted; False
        when the pool is exhausted (the engine then preempts and retries)
        or the slot's logical page table is full (``pages_per_slot`` --
        check ``table_full`` to tell the cases apart: eviction cannot
        help a full table).  Chunked prefill passes ``upto = done +
        chunk`` to allocate just ahead of the chunk front."""
        s = self.slots[slot]
        need = s.pos + 1 if upto is None else upto
        while need > len(s.pages) * self.page.page_tokens:
            if len(s.pages) >= self.pages_per_slot:
                return False
            ids = self.pool.alloc(1)
            if ids is None:
                return False
            s.pages.extend(ids)
        return True

    def table_full(self, slot: int) -> bool:
        """True when the slot has exhausted its logical page table (its
        sequence hit the ``pages_per_slot`` bound)."""
        return len(self.slots[slot].pages) >= self.pages_per_slot

    def victim(self, protect: int) -> Optional[int]:
        """Preemption victim: the occupied slot holding the newest request
        STRICTLY YOUNGER than ``protect``'s (rids are assigned at
        submission and survive requeueing, so re-admitted requests keep
        their seniority).  Restricting victims to younger slots is what
        makes preemption livelock-free: two growing slots can never evict
        each other in a ping-pong -- the younger one *stalls* (keeps its
        pages, skips the tick) until the older finishes, and the oldest
        slot always makes progress."""
        mine = self.slots[protect].rid
        others = [i for i, s in enumerate(self.slots)
                  if s is not None and i != protect and s.rid > mine]
        if not others:
            return None
        return max(others, key=lambda i: self.slots[i].rid)

    def evict(self, slot: int) -> Request:
        """Recompute preemption: free the slot's pages and requeue its
        request at the FRONT of the queue."""
        s = self.slots[slot]
        self.pool.free(s.live_pages)
        self.slots[slot] = None
        self.pending.appendleft(s.req)
        return s.req

    # ---------------------------------------------------------- retirement
    def finish(self, slot: int) -> None:
        s = self.slots[slot]
        self.pool.free(s.live_pages)
        self.slots[slot] = None

    def reclaim_window(self, slot: int, window: int) -> List[int]:
        """Free pages wholly below ``pos - window`` (their tokens can never
        attend again).  The page table keeps its logical shape; freed
        entries are masked by the kernel's window mask even after the
        physical page is rewritten by another slot."""
        s = self.slots[slot]
        if not window:
            return []
        lo = s.pos - window
        freed: List[int] = []
        for j, p in enumerate(s.pages):
            if p is not None and (j + 1) * self.page.page_tokens <= lo:
                freed.append(p)
                s.pages[j] = None
        if freed:
            self.pool.free(freed)
        return freed


# ---------------------------------------------------------------------------
# Pooled cache
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_tokens: int, n_logical_pages: int, dtype,
                     device) -> PyTree:
    """The pooled cache ``Model.decode_step_paged`` consumes, on
    ``device``: ``pool`` holds one ``(L, n_pages, page_tokens, KV, D)``
    buffer each for K and V, ``table`` the ``(n_slots, n_logical_pages)``
    int32 page table (0 = null page) and ``pos`` the per-slot positions.
    """
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving is not implemented for family {cfg.family!r}")
    shape = (cfg.n_layers, n_pages, page_tokens, cfg.n_kv_heads,
             cfg.head_dim)
    return {
        "table": torch.zeros((n_slots, n_logical_pages), dtype=torch.int32,
                             device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "pool": {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)},
        "state": {},
    }


def reset_slot(cfg: ModelConfig, cache: PyTree, slot: int) -> PyTree:
    """Reset one slot's per-slot state rows for a fresh (chunked) prefill.

    The dense family has no per-slot state besides its pages, and chunk
    writes land exactly on the slot's allocated pages, so there is nothing
    to reset; recurrent families will reset their state rows here.
    """
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving is not implemented for family {cfg.family!r}")
    del slot
    return cache
