"""Cross-request KV reuse: a radix prefix cache over the page pool (the
port of ``repro.serve.prefix``; numpy bookkeeping, as there).

Two requests that agree on a prefix produce the same KV for it (per-token
projections and RoPE at absolute positions), so the prefix need not be
prefilled twice.  Finished prompt pages are keyed by their token content
in a radix tree whose nodes hold refcounted pool pages, and admission
walks the tree so a matching request starts chunked prefill at the first
unshared token.

  * **Node = one completed page.**  A node is keyed by the exact token
    tuple of one ``page_tokens``-sized block; its path from the root
    spells the full prefix.  Each node holds one reference on its
    physical page (``PagePool.incref``), so ``pool.total_refs == slot
    refs + tree refs`` is the engine's per-tick ledger.
  * **Full pages map read-only.**  A hit increfs the matched chain's
    pages into the new slot's page table.  The suffix starts at or after
    the shared frontier and decode positions only grow, so KV writes only
    touch the slot's private pages (the engine asserts it every chunk and
    decode tick).
  * **Mid-page divergence = copy-on-write.**  When the shared prefix ends
    inside a page (attention families), the hit allocates a fresh page,
    the engine copies the partially matching node's page into it on the
    card, and the slot writes its suffix into the private copy.
  * **Recurrent state snapshots.**  Hybrid-SSM and xLSTM need the
    recurrent state after token ``i`` as well.  Chunked prefill snapshots
    each slot's state rows at page boundaries -- on the card, as clones of
    the slot's rows (a host copy of zamba2-1.2b's 40.8 MB a snapshot would
    make every chunk wait for the card) -- nodes store the snapshot, and
    hits for these families round DOWN to the deepest node boundary.
  * **Plan-consulted eviction.**  The tree's pages and snapshots are
    billed to the mesh-level HBM leftover the planner recorded
    (``HierarchicalPlan.prefix_budget()``).  Inserting past the budget
    evicts least-recently-used leaves no slot maps until the new node
    fits; pool pressure from live slots evicts the same way first
    (``PagedScheduler._alloc``).
  * **Snapshots are billed when they are taken.**  Pages live in the
    pool, but every snapshot is a new allocation on the card, so
    snapshots also have their own cap (``state_budget_bytes``: the
    engine's KV budget left after the pool).  A prefilling slot
    ``reserve``s each snapshot's bytes before it clones the rows -- the
    reservation evicts like an insertion -- and ``release``s them just
    before ``insert`` (or when the slot is preempted).  A refused
    reservation is never cloned, so resident plus pending snapshot bytes
    stay within both budgets whatever the prompts' lengths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PyTree = Any

#: Families whose prefix KV is exactly reusable across requests.  Pure
#: attention families reuse at token granularity (CoW inside a page);
#: recurrent-state families reuse at page granularity (state snapshots
#: exist only at page boundaries).  enc_dec is excluded: its decoder
#: self-KV depends on the encoder output through cross-attention, so
#: equal decoder prefixes do NOT imply equal KV.  vlm never pages.
PREFIX_FAMILIES = ("dense", "moe", "hybrid_ssm", "xlstm", "mla_moe")

#: Families that need a state snapshot restored at the hit boundary.
STATE_FAMILIES = ("hybrid_ssm", "xlstm")


@dataclass
class PrefixHit:
    """One admission-time match against the radix tree.

    ``tokens`` prompt tokens are already resident (always ``<
    prompt_len`` -- at least one suffix token remains so the final-token
    logits are computed, never replayed).  ``pages`` maps the slot's
    logical pages ``0..len-1``; all but a CoW page are SHARED (increffed)
    read-only mappings.  ``cow = (src, dst)`` asks the engine to
    device-copy page ``src`` into the private page ``dst`` (already
    allocated, last entry of ``pages``) before the suffix chunk runs.
    ``state`` is the recurrent-state snapshot to restore into the slot's
    state rows (state families only): ``{group: {name: tensor}}``, each
    tensor one slot's rows on the card."""

    tokens: int
    pages: List[int] = field(default_factory=list)
    cow: Optional[Tuple[int, int]] = None
    state: Optional[PyTree] = None


class _Node:
    __slots__ = ("key", "page", "state", "parent", "children",
                 "last_used", "cost")

    def __init__(self, key: Tuple[int, ...], page: Optional[int],
                 state: Optional[PyTree], parent: Optional["_Node"],
                 cost: int):
        self.key = key
        self.page = page                # physical pool page id (or None)
        self.state = state              # state snapshot after this block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.cost = cost                # logical bytes billed to budget


def _state_nbytes(state: Optional[PyTree]) -> int:
    """Bytes of a snapshot (nested dicts of tensors): the sum over its
    leaves of ``numel x element size``."""
    if state is None:
        return 0
    if isinstance(state, dict):
        return sum(_state_nbytes(v) for v in state.values())
    return state.numel() * state.element_size()


class RadixPrefixCache:
    """The radix tree + page-sharing policy (pure python, like the
    scheduler).  One instance persists across ``generate`` calls on the
    engine's paged session; ``PagedScheduler`` consults it at admission
    and squeezes it under pool pressure."""

    def __init__(self, page_tokens: int, page_bytes: int,
                 budget_bytes: int, pool, has_state: bool = False,
                 obs=None, tracer=None,
                 state_budget_bytes: Optional[int] = None):
        self.page_tokens = max(1, int(page_tokens))
        self.page_bytes = max(0, int(page_bytes))   # logical, 0=token-free
        self.budget_bytes = max(0, int(budget_bytes))
        # Cap on snapshot bytes on the card, resident plus pending (None:
        # snapshots are billed to ``budget_bytes`` only, as in the tree
        # this ports).
        self.state_budget_bytes = None if state_budget_bytes is None \
            else max(0, int(state_budget_bytes))
        self.pool = pool
        self.has_state = has_state
        self._root = _Node((), None, None, None, 0)
        self._nodes: List[_Node] = []           # flat registry (LRU scans)
        self._clock = 0                         # monotonic LRU clock
        self.resident_bytes = 0
        self.state_bytes = 0                    # resident snapshot bytes
        self.pending_bytes = 0                  # reserved, not yet inserted
        self.peak_state_bytes = 0               # max state + pending
        self.n_pages = 0                        # tree-held page references
        self.hits = 0
        self.misses = 0
        self.inserted_nodes = 0
        self.evicted_nodes = 0
        self.evicted_pages = 0
        # Observability hooks (DESIGN.md §13): hit/miss/evict land in
        # the trace; the resident-bytes gauges feed the plan-vs-actual
        # row for the mesh-level HBM leftover budgeting this tree.
        self.obs = obs
        self.tracer = tracer

    def _publish(self) -> None:
        self.peak_state_bytes = max(self.peak_state_bytes,
                                    self.state_bytes + self.pending_bytes)
        if self.obs is not None:
            self.obs.set("prefix_resident_bytes", self.resident_bytes,
                         unit="B")
            self.obs.set_max("prefix_peak_resident_bytes",
                             self.resident_bytes, unit="B")

    def _record_miss(self) -> None:
        self.misses += 1
        if self.tracer is not None:
            self.tracer.instant("prefix_miss")

    # ----------------------------------------------------------------- LRU
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # ------------------------------------------------------------ matching
    def _block(self, tokens: np.ndarray, j: int) -> Tuple[int, ...]:
        t = self.page_tokens
        return tuple(int(x) for x in tokens[j * t:(j + 1) * t])

    def _walk(self, tokens: np.ndarray) -> List[_Node]:
        """The chain of fully-matching page nodes from the root."""
        chain: List[_Node] = []
        node = self._root
        for j in range(len(tokens) // self.page_tokens):
            child = node.children.get(self._block(tokens, j))
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    @property
    def n_nodes(self) -> int:
        """Resident node count (``engine.stats()`` / router telemetry)."""
        return len(self._nodes)

    def match(self, tokens: np.ndarray):
        """Read-only longest page-aligned match -- the disaggregation
        EXPORT lookup (``ServeEngine.export_pages``): no refcounts move,
        no CoW page is allocated, matched nodes are only LRU-touched.
        Returns ``(covered_tokens, page_ids, snaps)`` where ``snaps`` maps
        page-boundary token counts to state snapshots (state families;
        empty otherwise).  A chain stops at the first node
        without a page (token-free families) or, for state families,
        without a snapshot -- a partial transfer would be unresumable."""
        tokens = np.asarray(tokens).reshape(-1)
        chain = self._walk(tokens)
        t = self.page_tokens
        covered = 0
        pages: List[int] = []
        snaps: Dict[int, PyTree] = {}
        for j, node in enumerate(chain):
            if self.page_bytes > 0 and node.page is None:
                break
            if self.has_state and node.state is None:
                break
            if node.page is not None:
                pages.append(node.page)
            if node.state is not None:
                snaps[(j + 1) * t] = node.state
            covered = (j + 1) * t
            self._touch(node)
        return covered, pages, snaps

    def admit(self, tokens: np.ndarray) -> Optional[PrefixHit]:
        """Match ``tokens`` against the tree and, on a hit, take the page
        references the new slot will hold: one incref per shared full
        page, plus one freshly-allocated private page when the prefix
        ends mid-page (the CoW copy itself is the engine's job -- this
        layer never touches device memory).  Returns None on a miss."""
        tokens = np.asarray(tokens).reshape(-1)
        plen = int(tokens.shape[0])
        t = self.page_tokens
        if plen < 2:
            self._record_miss()
            return None                   # no room for a suffix token
        chain = self._walk(tokens)
        deepest = chain[-1] if chain else self._root
        # Longest common in-page token run against the next block's
        # children -- the CoW candidate (attention families only: a
        # recurrent state cannot be restored mid-page).
        part_d, part_node = 0, None
        if not self.has_state:
            j = len(chain)
            block = tuple(int(x) for x in tokens[j * t:(j + 1) * t])
            for key, child in deepest.children.items():
                d = 0
                for a, b in zip(key, block):
                    if a != b:
                        break
                    d += 1
                if d > part_d and child.page is not None:
                    part_d, part_node = d, child
        hit = min(len(chain) * t + part_d, plen - 1)
        full = hit // t
        if full < len(chain) and not self.has_state:
            # The whole prompt is cached (the ``plen - 1`` cap bit): the
            # final partial page CoWs from the next fully-matched node.
            part_node = chain[full] if chain[full].page is not None else None
        part_d = hit - full * t
        if part_d and part_node is None:
            hit, part_d = full * t, 0     # round down: nothing to CoW from
        if self.has_state:
            full = min(full, len(chain))
            hit, part_d, part_node = full * t, 0, None
        if hit <= 0:
            self._record_miss()
            return None
        state = chain[full - 1].state if self.has_state and full else None
        pages: List[int] = []
        for node in chain[:full]:
            if node.page is None:
                break                     # token-free family: no pages
            self.pool.incref(node.page)
            pages.append(node.page)
        cow = None
        if part_d and part_node is not None:
            dst = self._alloc_private()
            if dst is None:
                hit = full * t            # degrade to the full-page hit
                if hit <= 0:
                    self._record_miss()
                    return None
            else:
                cow = (part_node.page, dst)
                pages.append(dst)
                self._touch(part_node)
        for node in chain[:full]:
            self._touch(node)
        self.hits += 1
        if self.tracer is not None:
            self.tracer.instant("prefix_hit",
                                args={"tokens": hit,
                                      "cow": cow is not None})
        return PrefixHit(tokens=hit, pages=pages, cow=cow, state=state)

    def _alloc_private(self) -> Optional[int]:
        ids = self.pool.alloc(1)
        if ids is None:
            self.release_pages(need=1)
            ids = self.pool.alloc(1)
        return ids[0] if ids else None

    # ----------------------------------------------------------- insertion
    def insert(self, tokens: np.ndarray, slot_pages: List[Optional[int]],
               snaps: Optional[Dict[int, PyTree]] = None) -> int:
        """Publish a finished prefill's COMPLETED pages into the tree.

        ``slot_pages`` is the slot's logical page table at prefill
        completion; only the ``prompt_len // page_tokens`` full prompt
        pages are cacheable (the partial tail page will be decoded into).
        ``snaps`` maps page-boundary token counts to state snapshots
        (state families; a chain stops at the first boundary without
        one).  Existing nodes are LRU-touched, new nodes incref their
        page; insertion stops when the budget cannot be made to fit even
        after evicting every unreferenced leaf.  Returns the number of
        nodes created."""
        tokens = np.asarray(tokens).reshape(-1)
        t = self.page_tokens
        node = self._root
        created = 0
        for j in range(int(tokens.shape[0]) // t):
            key = self._block(tokens, j)
            child = node.children.get(key)
            if child is not None:
                self._touch(child)
                node = child
                continue
            page = None
            if self.page_bytes > 0:
                if j >= len(slot_pages) or slot_pages[j] is None:
                    break                 # window-reclaimed: chain ends
                page = slot_pages[j]
            state = None
            if self.has_state:
                state = (snaps or {}).get((j + 1) * t)
                if state is None:
                    break                 # no snapshot at this boundary
            state_cost = _state_nbytes(state)
            cost = self.page_bytes + state_cost
            if not self._make_room(cost, state_cost):
                break
            if page is not None:
                self.pool.incref(page)
                self.n_pages += 1
            child = _Node(key, page, state, node, cost)
            node.children[key] = child
            self._nodes.append(child)
            self.resident_bytes += cost
            self.state_bytes += state_cost
            self.inserted_nodes += 1
            created += 1
            self._touch(child)
            node = child
        self._publish()
        return created

    # ------------------------------------------------------------ eviction
    def _evictable(self, node: _Node) -> bool:
        """Evictable = a leaf no slot references: interior nodes keep
        their children's prefix valid, and a page some slot still maps
        (refcount > 1: tree ref + slot refs) is in active use."""
        return not node.children and (
            node.page is None or self.pool.refcount(node.page) == 1)

    def _evict_one(self, need_page: bool = False) -> bool:
        """Drop the least-recently-used evictable leaf (set ``need_page``
        to only consider page-holding leaves -- pool pressure wants
        physical pages back, not state bytes)."""
        best = None
        for node in self._nodes:
            if not self._evictable(node):
                continue
            if need_page and node.page is None:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        if best is None:
            return False
        del best.parent.children[best.key]
        self._nodes.remove(best)
        if best.page is not None:
            self.pool.free([best.page])   # decref: tree held rc 1
            self.n_pages -= 1
            self.evicted_pages += 1
        self.resident_bytes -= best.cost
        self.state_bytes -= _state_nbytes(best.state)
        self.evicted_nodes += 1
        if self.tracer is not None:
            self.tracer.instant("prefix_evict",
                                args={"page": best.page,
                                      "resident": self.resident_bytes})
        self._publish()
        return True

    def _fits(self, cost: int, state_cost: int) -> bool:
        if self.resident_bytes + self.pending_bytes + cost > \
                self.budget_bytes:
            return False
        return self.state_budget_bytes is None or \
            self.state_bytes + self.pending_bytes + state_cost <= \
            self.state_budget_bytes

    def _make_room(self, cost: int, state_cost: int = 0) -> bool:
        """Evict LRU leaves until ``cost`` more bytes (``state_cost`` of
        them snapshot bytes) fit the plan's budget and the snapshot cap,
        beside the pending reservations.  Repeated leaf eviction IS
        subtree eviction: an interior node becomes a leaf once its
        children go."""
        if cost > self.budget_bytes or (
                self.state_budget_bytes is not None
                and state_cost > self.state_budget_bytes):
            return False
        while not self._fits(cost, state_cost):
            if not self._evict_one():
                return False
        return True

    def reserve(self, nbytes: int) -> bool:
        """Bill a snapshot of ``nbytes`` before it is taken: evict until
        it fits both budgets beside what is resident and pending, then
        hold the bytes as pending.  False (nothing held) when the tree
        cannot make room: the caller takes no snapshot."""
        if not self._make_room(nbytes, nbytes):
            return False
        self.pending_bytes += nbytes
        self._publish()
        return True

    def release(self, nbytes: int) -> None:
        """Return pending snapshot bytes (just before ``insert`` bills the
        snapshots for good, or when their slot is preempted)."""
        self.pending_bytes = max(0, self.pending_bytes - int(nbytes))

    def release_pages(self, need: int = 1) -> int:
        """Pool back-pressure: evict page-holding LRU leaves until the
        pool can grant ``need`` pages (or nothing evictable remains).
        Returns the number of pages returned to the free list."""
        freed = 0
        while self.pool.free_pages < need:
            if not self._evict_one(need_page=True):
                break
            freed += 1
        return freed

    def clear(self) -> int:
        """Evict every evictable node (tests / explicit cache drops)."""
        n = 0
        while self._evict_one():
            n += 1
        return n
