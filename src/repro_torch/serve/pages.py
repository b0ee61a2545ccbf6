"""The global KV page pool: plan-sized pages, per-slot tables, slot-level
admission (the port of ``repro.serve.pages`` for the dense, moe,
mla_moe, hybrid_ssm, xlstm and enc_dec families).

  * ``PagePool`` -- the physical pool: ``pages_total`` pages of
    ``page_plan()["page_tokens"]`` tokens each, a refcounted free list and
    cumulative alloc/release counters.  Physical page 0 is the reserved
    *null page*: empty slots' decode writes land there and nothing ever
    reads it unmasked.  A page shared by several slot tables and the
    prefix cache's tree carries one reference per mapping.
  * ``PagedScheduler`` -- slot-level admission, pure python: a fixed batch
    of decode slots, FIFO admission of one request per free slot, one-page
    growth, youngest-slot recompute preemption, and sliding-window page
    reclaim.  A finished slot frees its pages at once and is backfilled by
    the next pending request mid-flight.  With a prefix cache
    (``serve.prefix``), admission starts a matching request after its
    cached prefix, and an allocation the free list refuses first evicts
    cached pages.  A token-free family (xLSTM: ``page_bytes == 0``) holds
    no pages at all; its slots only gate admission.
  * ``init_paged_cache`` / ``reset_slot`` -- the pooled cache dict the
    paged steps (``Model.decode_step_paged`` / ``prefill_chunk``) consume:
    ``pool`` (``k``/``v``, each ``(L, P, T, KV, D)``, or mla_moe's latent
    ``lat``, ``(L, P, T, 1, R + dr)``), ``table`` (the per-slot page
    table), ``pos`` (the per-slot position vector) and ``state`` (per-slot
    recurrent buffers, and enc_dec's cross K/V: the slot on axis 1 of a
    layer-stacked buffer, on axis 0 of a per-slot vector); ``reset_slot``
    puts one slot's state back to ``Model.init_state``'s values and
    installs an enc-dec request's cross K/V.
  * ``export_pool_pages`` / ``install_pool_pages`` -- physical pages as
    host numpy payloads, one ``(L, page_tokens, KV, D)`` array per pool
    buffer, and back into another pool in place; ``copy_page`` -- the
    prefix cache's copy-on-write of one page.

On a mesh the pool and the state buffers are DTensors (the page dim never
shards), and every read and write here goes through each rank's own
shard: a payload is whole either way.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (from_local_like, read_rows, rows_like,
                                       write_rows)
from repro_torch.serve.kvcache import PageSpec, attn_apps
from repro_torch.serve.scheduler import Request

PyTree = Any

#: Families with a per-slot paged decode path in the port.  enc-dec pages
#: its decoder self-attention K/V; its cross K/V is per-slot state.
PAGED_FAMILIES = ("dense", "moe", "mla_moe", "hybrid_ssm", "xlstm",
                  "enc_dec")

#: Per-slot recurrent-state groups per family: the buffers a decode step
#: writes (reset at admission).  enc_dec's flat cross state is written only
#: at admission and read by every step.
STATE_GROUPS = {"hybrid_ssm": ("mamba",), "xlstm": ("mlstm", "slstm")}


# ---------------------------------------------------------------------------
# Physical pool
# ---------------------------------------------------------------------------


class PagePool:
    """Refcounting free-list allocator over the physical page pool.

    ``pages_total`` includes the reserved null page 0, which is never
    allocated or freed.  Every page carries a reference count: ``alloc``
    hands out pages at refcount 1, ``incref`` adds a read-only mapping
    (the prefix cache sharing one physical page into several slot tables
    and its radix tree), and ``free`` decrefs -- the page returns to the
    free list only when its last reference drops.  Freeing a page that
    holds no reference (double free, or a scheduler bug returning a page it
    never owned) raises instead of silently corrupting the free list.

    ``pages_allocated`` / ``pages_released`` count physical transitions
    (free list -> used and back), so ``pages_allocated - pages_released ==
    used_pages`` stays an invariant under sharing and ``assert_reconciled``
    pins it after every op.
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

    @property
    def total_refs(self) -> int:
        """Sum of live refcounts: slot-table references + prefix-tree
        references (the ledger the engine reconciles every tick)."""
        return sum(self._rc)

    def refcount(self, pid: int) -> int:
        return self._rc[pid]

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

    def incref(self, pid: int) -> None:
        """Add a reference to a live page (a shared read-only mapping).
        Increffing a free page would resurrect it without removing it
        from the free list, so that raises."""
        if pid <= 0 or pid >= self.pages_total:
            raise ValueError(f"incref of invalid page id {pid}")
        if self._rc[pid] <= 0:
            raise ValueError(f"incref of free page {pid}")
        self._rc[pid] += 1

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
        can grant its first page (none for a token-free family); the
        prompt's other pages are granted as its chunks arrive, and a
        windowed prompt's pages wholly below the window are reclaimed
        behind the chunk front, so it is billed for its resident window.
        With a prefix cache, a head whose prompt matches a cached prefix
        starts after it instead, the shared pages mapped into its table.
        A lone head that can never fit an empty pool raises.
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
                 pages_per_slot: int, window: int = 0, prefix=None):
        self.pool = pool
        self.page = page
        self.n_slots = max(1, n_slots)
        self.pages_per_slot = max(1, pages_per_slot)
        self.window = max(0, window)
        self.prefix = prefix            # serve.prefix.RadixPrefixCache|None
        self.slots: List[Optional[SlotState]] = [None] * self.n_slots
        self.pending: Deque[Request] = deque()

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pool alloc with prefix-cache back-pressure: when the free list
        cannot grant ``n`` pages, evict unreferenced radix-tree pages (LRU)
        before giving up -- live slots outrank cached prefixes."""
        ids = self.pool.alloc(n)
        if ids is None and self.prefix is not None:
            self.prefix.release_pages(need=n)
            ids = self.pool.alloc(n)
        return ids

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

    def admit(self) -> List[Tuple[int, Request, List[Optional[int]], Any]]:
        """Fill free slots from the queue head for CHUNKED prefill.
        Returns ``[(slot, request, logical_pages, hit), ...]``: each slot
        starts at ``pos = 0`` with only its FIRST page allocated -- the
        engine grows it page by page ahead of the chunk front
        (``ensure_capacity(slot, upto=...)``) and window-reclaims behind
        it.  With a prefix cache attached, admission first consults the
        radix tree: a hit (``serve.prefix.PrefixHit``, else None) starts
        the slot at ``pos = hit.tokens`` with the shared prefix pages
        mapped read-only (increffed) into its table, so prefill covers
        only the unshared suffix.  A lone head that cannot get one page
        of an empty pool raises.
        """
        out: List[Tuple[int, Request, List[Optional[int]], Any]] = []
        first = 1 if self.page.page_bytes > 0 else 0
        for slot, s in enumerate(self.slots):
            if s is not None or not self.pending:
                continue
            head = self.pending[0]
            hit = None
            if self.prefix is not None and head.features and \
                    "tokens" in head.features:
                hit = self.prefix.admit(
                    np.asarray(head.features["tokens"]).reshape(-1))
            if hit is not None:
                self.pending.popleft()
                self.slots[slot] = SlotState(rid=head.rid, req=head,
                                             pos=hit.tokens,
                                             pages=list(hit.pages))
                out.append((slot, head, list(hit.pages), hit))
                continue
            ids = self._alloc(first) if first else []
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
            out.append((slot, head, list(ids), None))
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
        chunk`` to allocate just ahead of the chunk front.  A token-free
        family always has room."""
        s = self.slots[slot]
        if self.page.page_bytes <= 0:
            return True                   # token-free family: no pages
        need = s.pos + 1 if upto is None else upto
        while need > len(s.pages) * self.page.page_tokens:
            if len(s.pages) >= self.pages_per_slot:
                return False
            ids = self._alloc(1)
            if ids is None:
                return False
            s.pages.extend(ids)
        return True

    def table_full(self, slot: int) -> bool:
        """True when the slot has exhausted its logical page table (its
        sequence hit the ``pages_per_slot`` bound; never for a token-free
        family)."""
        return self.page.page_bytes > 0 and \
            len(self.slots[slot].pages) >= self.pages_per_slot

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
                     device, enc_len: int = 0) -> PyTree:
    """The pooled cache ``Model.decode_step_paged`` consumes, on
    ``device``: ``pool`` holds one ``(L, n_pages, page_tokens, KV, D)``
    buffer each for K and V, ``table`` the ``(n_slots, n_logical_pages)``
    int32 page table (0 = null page), ``pos`` the per-slot positions and
    ``state`` the per-slot recurrent state of ``Model.init_state``.

    dense and moe: one pool layer per layer, no state.  mla_moe: one
    latent pool ``lat`` of ``(L, n_pages, page_tokens, 1, R + dr)`` -- the
    absorbed-form cache row, one "KV head" -- and no state.  hybrid_ssm: one
    pool layer per application of the shared attention block, and
    ``state["mamba"]``.  xlstm is token-free: no pool, and
    ``state["mlstm"]`` and ``state["slstm"]`` are its whole cache.
    enc_dec: one pool layer per decoder layer, and the flat state
    ``cross_k``/``cross_v`` ``(nd, n_slots, enc_len, KV, D)`` in ``dtype``
    (``enc_len``: the longest encoder the run serves) and ``enc_len``
    ``(n_slots,)`` int32.
    """
    from repro_torch.models.model import Model

    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving is not implemented for family {cfg.family!r}")
    pool_layers = {"dense": cfg.n_layers, "moe": cfg.n_layers,
                   "hybrid_ssm": attn_apps(cfg)}.get(cfg.family, 0)
    if cfg.family == "enc_dec":
        pool_layers = cfg.enc_dec.n_decoder_layers
    cache = {
        "table": torch.zeros((n_slots, n_logical_pages), dtype=torch.int32,
                             device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "pool": {},
        "state": Model(cfg).init_state(n_slots, dtype, device),
    }
    if cfg.family == "mla_moe":
        m = cfg.mla
        cache["pool"] = {"lat": torch.zeros(
            (cfg.n_layers, n_pages, page_tokens, 1,
             m.kv_lora_rank + m.rope_head_dim), dtype=dtype, device=device)}
    elif pool_layers:
        shape = (pool_layers, n_pages, page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["pool"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "enc_dec":
        shape = (pool_layers, n_slots, enc_len, cfg.n_kv_heads, cfg.head_dim)
        cache["state"] = {
            "cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device),
            "enc_len": torch.zeros((n_slots,), dtype=torch.int32,
                                   device=device),
        }
    return cache


def reset_slot(cfg: ModelConfig, cache: PyTree, slot: int,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               enc_len: int = 0) -> PyTree:
    """Reset one slot's per-slot state rows for a fresh (chunked) prefill
    to the family's ``Model.init_state`` values -- not zeros: xLSTM's
    stabiliser rows start at the running max's floor -- and, for enc_dec,
    install the request's cross K/V (``cross_kv``: ``(nd, 1, Se, KV, D)``
    each) into the slot's rows, zero the rows past its ``Se`` and set
    ``enc_len[slot]``.  The pool needs no reset: chunk writes land exactly
    on the slot's allocated pages.  In place; returns the cache.
    """
    from repro_torch.models.model import Model

    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving is not implemented for family {cfg.family!r}")
    groups = STATE_GROUPS.get(cfg.family, ())
    if groups:
        device = cache["pos"].device
        fresh = Model(cfg).init_state(1, torch.float32, device)
        for g in groups:
            for k, buf in cache["state"][g].items():
                set_slot_rows(buf, slot, slot_rows(fresh[g][k], 0))
    if cfg.family == "enc_dec":
        state = cache["state"]
        for name, src in zip(("cross_k", "cross_v"), cross_kv):
            buf = state[name]
            if isinstance(buf, DTensor):
                # The whole row, zero past Se, through the local shards.
                row = src.new_zeros((buf.shape[0],) + tuple(buf.shape[2:]))
                row[:, :src.shape[2]] = src[:, 0]
                set_slot_rows(buf, slot, row)
                continue
            row = slot_rows(buf, slot)                # (nd, Se_max, KV, D)
            row[:, :src.shape[2]] = src[:, 0]
            row[:, src.shape[2]:] = 0
        set_slot_rows(state["enc_len"], slot, enc_len)
    return cache


def slot_rows(buf: torch.Tensor, slots) -> torch.Tensor:
    """The rows of ``slots`` (an index or an index tensor) in a per-slot
    state buffer: the slot is axis 1 of a layer-stacked buffer (two or
    more dims) and axis 0 of a per-slot vector, as the reference's engine
    takes it.  On a mesh (``buf`` a DTensor whose slot axis may shard over
    the data axes) the rows come off the local shards, replicated over the
    slot axis (``dist.sharding.read_rows``): a copy, not a view."""
    dim = 1 if buf.dim() >= 2 else 0
    if isinstance(buf, DTensor):
        return read_rows(buf, dim, slots)
    return buf[:, slots] if dim else buf[slots]


def place_slot_rows(buf: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """One slot's rows (shaped as ``slot_rows(buf, slot)`` returns them)
    placed as ``slot_rows`` places them: on a mesh a DTensor replicated
    over the slot axis and split as ``buf`` splits its other dims (each
    rank keeps its own heads' rows); the identity off one."""
    if not isinstance(buf, DTensor):
        return value
    dim = 1 if buf.dim() >= 2 else 0
    return rows_like(buf, dim, value.unsqueeze(dim)).select(dim, 0)


def set_slot_rows(buf: torch.Tensor, slots, value) -> None:
    """Write ``value`` (a tensor or a scalar) into the rows of ``slots`` of
    a per-slot state buffer (the axis as in ``slot_rows``), in place, cast
    to its dtype; on a mesh each rank writes the rows its shard holds
    (``dist.sharding.write_rows``)."""
    dim = 1 if buf.dim() >= 2 else 0
    if isinstance(buf, DTensor):
        write_rows(buf, dim, slots, value)
    elif dim:
        buf[:, slots] = value
    else:
        buf[slots] = value


# ---------------------------------------------------------------------------
# Sharding axes for the pooled layout (consumed by serve.steps)
# ---------------------------------------------------------------------------


def paged_cache_logical_axes(cfg: ModelConfig, cache: PyTree) -> PyTree:
    """Logical sharding axes for the pooled cache: the pool's KV heads
    shard like the dense cache's ("kv_heads", which ``with_kv_sharding``
    maps to the model axis or not); the page dim ("kv_pages") is a pool
    dim and never shards -- a page is the shared-memory streaming granule
    of ONE card.  The per-slot state takes the dense cache's axis names
    (``launch.specs.cache_logical_axes``); enc_dec's cross rows shard
    over heads.  The page table and positions are replicated (and stay
    on the host side of the engine, the same on every rank)."""
    from repro_torch.launch.specs import cache_logical_axes

    axes: Dict[str, Any] = {"table": (None, None), "pos": (None,),
                            "pool": {}, "state": {}}
    if cache.get("pool"):
        pool_ax = ("layers", "kv_pages", None, "kv_heads", None)
        axes["pool"] = {name: pool_ax[:cache["pool"][name].dim()]
                        for name in cache["pool"]}
    if cache.get("state"):
        state = dict(cache["state"])
        cross = {}
        for name in ("cross_k", "cross_v"):
            if name in state:
                state.pop(name)
                cross[name] = ("layers", None, None, "kv_heads", None)
        if "enc_len" in state:
            state.pop("enc_len")
            cross["enc_len"] = (None,)
        axes["state"] = cache_logical_axes(cfg, state, False) if state \
            else {}
        axes["state"].update(cross)
    return axes


# ---------------------------------------------------------------------------
# Page serialization (export from one engine's pool, install into another)
# ---------------------------------------------------------------------------


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (a DTensor gathered whole); bf16,
    which numpy lacks, travels as float32 (exact) and is cast back on
    install."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def copy_page(buf: torch.Tensor, src: int, dst: int) -> None:
    """Copy physical page ``src`` of a pool buffer ``(L, P, ...)`` onto page
    ``dst``, in place (the prefix cache's copy-on-write).  On a mesh each
    rank copies its own shard of the page: the page dim never shards."""
    if isinstance(buf, DTensor):
        buf = buf.to_local()
    buf[:, dst].copy_(buf[:, src])


def export_pool_pages(cache: PyTree, page_ids: Sequence[int]
                      ) -> List[Dict[str, np.ndarray]]:
    """Serialize physical pool pages as host arrays, one payload per page:
    each maps the pool's buffer names ("k"/"v", or "lat" for MLA) to an
    ``(L, page_tokens, KV, D)`` array, the cross-layer slice of ONE
    physical page.  Payloads are keyed by position in the logical page
    chain, never by physical id: physical numbering is private to each
    pool.  One gather and one copy to the host per buffer; on a mesh the
    pages are taken from each rank's shard and gathered whole, so the
    payloads are the meshless engine's."""
    if not page_ids:
        return []
    idx = torch.tensor([int(p) for p in page_ids], dtype=torch.long)

    def pages(buf):
        if not isinstance(buf, DTensor):
            return buf[:, idx.to(buf.device)]
        local = buf.to_local()
        return from_local_like(
            local[:, idx.to(local.device)], buf.device_mesh,
            tuple(buf.placements),
            (buf.shape[0], len(page_ids)) + tuple(buf.shape[2:]))

    host = {name: host_array(pages(buf))
            for name, buf in cache["pool"].items()}
    return [{name: arr[:, i] for name, arr in host.items()}
            for i in range(len(page_ids))]


def install_pool_pages(cache: PyTree, page_ids: Sequence[int],
                       payloads: Sequence[Dict[str, Any]]) -> PyTree:
    """Install serialized page payloads into this pool's physical pages,
    in place: the i-th payload lands on ``page_ids[i]`` (freshly allocated
    pages of the receiving pool).  Buffer names and per-page shapes must
    match the receiving pool's layout -- both sides plan the same
    geometry, so a mismatch is an error, not a fallback.  On a mesh each
    rank writes its own shard of every page (``dist.sharding.write_rows``):
    a payload is whole, as the meshless engine exports it.  Returns the
    cache."""
    if len(page_ids) != len(payloads):
        raise ValueError(f"{len(page_ids)} pages for {len(payloads)} payloads")
    for name, buf in cache["pool"].items():
        page_shape = buf.shape[:1] + buf.shape[2:]
        for pid, payload in zip(page_ids, payloads):
            if name not in payload:
                raise ValueError(f"payload missing pool buffer {name!r}")
            data = torch.as_tensor(np.asarray(payload[name]))
            if data.shape != page_shape:
                raise ValueError(
                    f"page payload {name!r} shape {tuple(data.shape)} != "
                    f"pool page shape {tuple(page_shape)}")
            data = data.to(buf.device, buf.dtype)
            if isinstance(buf, DTensor):
                write_rows(buf, 1, int(pid), data)
            else:
                buf[:, int(pid)].copy_(data)
    return cache
