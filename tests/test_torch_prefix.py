"""The port's refcounted page pool, radix prefix tree and prefix budget
against the JAX package's.

* ``PagePool.free`` is a decref: double frees and frees of never-allocated
  pages raise, and a page shared by ``incref`` stays out of the free list
  until its last reference drops (``tests/test_serve_prefix.py``'s
  guards).
* Random insert / admit / match / finish / pool-pressure sequences drive
  the port's ``RadixPrefixCache`` and the JAX one side by side, each over
  its own pool: after every operation the hits, page ids, CoW pairs,
  snapshots, resident bytes, evictions and free lists are equal, and the
  reference test's invariants hold (refcounts = slot refs + tree refs,
  flow counters reconcile, the tree stays inside its budget).
* ``plan.prefix_budget()`` is the page table's recorded HBM leftover,
  equals the JAX plan's, survives a JSON round trip, falls back for plans
  serialized before the field existed, and is None without a page level.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.launch.mesh import make_host_mesh
from repro.serve.engine import plan_decode as ref_plan_decode
from repro.serve.pages import PagePool as RefPool
from repro.serve.prefix import RadixPrefixCache as RefCache
from repro_torch.configs import get_model_config
from repro_torch.core.plan import HierarchicalPlan
from repro_torch.hw import h100_spec
from repro_torch.serve import PagePool, RadixPrefixCache, plan_decode
from repro_torch.serve.prefix import _state_nbytes

# ---------------------------------------------------------------------------
# PagePool refcount guards
# ---------------------------------------------------------------------------


def test_double_free_raises():
    pool = PagePool(5)
    ids = pool.alloc(2)
    pool.free(ids)
    with pytest.raises(ValueError, match="double free"):
        pool.free([ids[0]])


def test_free_of_never_allocated_page_raises():
    pool = PagePool(5)
    pool.alloc(1)
    with pytest.raises(ValueError, match="double free|never-allocated"):
        pool.free([3])                    # page 3 was never handed out


def test_null_page_free_raises():
    with pytest.raises(ValueError, match="null page"):
        PagePool(5).free([0])


def test_shared_page_survives_first_free():
    pool = PagePool(5)
    (pid,) = pool.alloc(1)
    pool.incref(pid)                      # second mapping (rc=2)
    before = pool.free_pages
    pool.free([pid])                      # decref: still referenced
    assert pool.free_pages == before
    assert pool.refcount(pid) == 1 and pool.total_refs == 1
    assert pool.used_pages == 1           # physically still used
    pool.free([pid])                      # last reference: really freed
    assert pool.refcount(pid) == 0 and pool.total_refs == 0
    assert pool.used_pages == 0
    with pytest.raises(ValueError, match="double free"):
        pool.free([pid])
    pool.assert_reconciled()


def test_incref_of_free_page_raises():
    pool = PagePool(5)
    with pytest.raises(ValueError, match="free page"):
        pool.incref(1)                    # never allocated
    with pytest.raises(ValueError, match="invalid page"):
        pool.incref(0)                    # the null page


# ---------------------------------------------------------------------------
# The radix tree, op for op against the reference's
# ---------------------------------------------------------------------------


class _Side:
    """One tree over its own pool, with the simulated slot tables that
    hold page references (``tests/test_serve_prefix.py``'s harness)."""

    def __init__(self, pool_cls, cache_cls, t, pool_pages, budget, state):
        self.pool = pool_cls(pool_pages + 1)      # +1: the null page
        self.cache = cache_cls(t, t * 16, budget, self.pool,
                               has_state=state)
        self.tables = {}

    def request(self, toks, snaps):
        """Admit, allocate the suffix pages as chunked prefill would, and
        publish; returns ``(hit, pages or None if aborted)``."""
        hit = self.cache.admit(toks)
        pages = list(hit.pages) if hit else []
        t = self.cache.page_tokens
        while len(pages) * t < len(toks) + 1:
            ids = self.pool.alloc(1)
            if ids is None:
                self.cache.release_pages(need=1)
                ids = self.pool.alloc(1)
            if ids is None:
                self.pool.free(pages)     # recompute preemption
                return hit, None
            pages.extend(ids)
        self.cache.insert(toks, pages, snaps=snaps)
        return hit, pages

    def check(self):
        self.pool.assert_reconciled()
        slot_refs = sum(len(v) for v in self.tables.values())
        assert self.pool.total_refs == slot_refs + self.cache.n_pages
        assert self.cache.resident_bytes <= self.cache.budget_bytes

    def summary(self):
        c = self.cache
        return (c.resident_bytes, c.n_pages, c.n_nodes, c.hits, c.misses,
                c.inserted_nodes, c.evicted_nodes, c.evicted_pages,
                list(self.pool._free), list(self.pool._rc),
                self.pool.pages_allocated, self.pool.pages_released)


def _same_state(mine, ref):
    if mine is None or ref is None:
        return mine is None and ref is None
    return all(np.array_equal(mine["g"][k].numpy(), ref["g"][k])
               for k in ref["g"])


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), page_tokens=st.sampled_from([4, 8]),
       pool_pages=st.integers(6, 24), budget_pages=st.integers(1, 8),
       vocab=st.sampled_from([2, 3]), state=st.booleans())
def test_radix_tree_matches_reference(seed, page_tokens, pool_pages,
                                      budget_pages, vocab, state):
    rng = np.random.default_rng(seed)
    t = page_tokens
    # A state family's node also bills its snapshot (a (2, 3) f32 and a
    # (4,) f32: 40 bytes) to the budget.
    budget = budget_pages * (t * 16 + (40 if state else 0))
    mine = _Side(PagePool, RadixPrefixCache, t, pool_pages, budget, state)
    ref = _Side(RefPool, RefCache, t, pool_pages, budget, state)
    sid, history = 0, []
    for _ in range(60):
        op = rng.random()
        if op < 0.5:
            toks = rng.integers(0, vocab, int(rng.integers(1, 5 * t)))
            if history and rng.random() < 0.5:
                # Half the prompts extend a cut of an earlier one: hits on
                # full pages (state snapshots) as well as mid-page CoWs.
                base = history[int(rng.integers(len(history)))]
                cut = int(rng.integers(1, len(base) + 1))
                toks = np.concatenate([base[:cut], toks[:int(
                    rng.integers(0, 2 * t))]])
            toks = toks.astype(np.int64)
            history.append(toks)
            plen = len(toks)
            snaps_ref = snaps = None
            if state:
                snaps_ref = {(j + 1) * t: {"g": {
                    "a": rng.standard_normal((2, 3)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)}}
                    for j in range(plen // t)}
                snaps = {n: {"g": {k: torch.from_numpy(v.copy())
                                   for k, v in s["g"].items()}}
                         for n, s in snaps_ref.items()}
            hit, pages = mine.request(toks, snaps)
            hit_ref, pages_ref = ref.request(toks, snaps_ref)
            assert (hit is None) == (hit_ref is None)
            if hit is not None:
                assert (hit.tokens, hit.pages, hit.cow) == \
                    (hit_ref.tokens, hit_ref.pages, hit_ref.cow)
                assert _same_state(hit.state, hit_ref.state)
            assert pages == pages_ref
            if pages is not None:
                mine.tables[sid], ref.tables[sid] = pages, pages_ref
                sid += 1
            # The read-only export lookup agrees too.
            got, want = mine.cache.match(toks), ref.cache.match(toks)
            assert got[:2] == want[:2] and sorted(got[2]) == sorted(want[2])
        elif op < 0.8 and mine.tables:
            done = int(rng.choice(sorted(mine.tables)))
            mine.pool.free(mine.tables.pop(done))
            ref.pool.free(ref.tables.pop(done))
        else:
            need = int(rng.integers(1, 4))
            assert mine.cache.release_pages(need=need) == \
                ref.cache.release_pages(need=need)
        mine.check()
        ref.check()
        assert mine.summary() == ref.summary()
    for side in (mine, ref):
        for pages in side.tables.values():
            side.pool.free(pages)
        side.tables.clear()
    assert mine.cache.clear() == ref.cache.clear()
    mine.check()
    assert mine.pool.used_pages == mine.pool.total_refs == 0
    assert mine.summary() == ref.summary()


def test_state_nbytes_counts_each_leaf_in_its_dtype():
    snap = {"mamba": {"ssm": torch.zeros((2, 3, 4), dtype=torch.float32),
                      "conv": torch.zeros((2, 5), dtype=torch.bfloat16)}}
    assert _state_nbytes(snap) == 2 * 3 * 4 * 4 + 2 * 5 * 2
    assert _state_nbytes(None) == 0


# ---------------------------------------------------------------------------
# The plan's prefix budget
# ---------------------------------------------------------------------------


def _strip(node):
    """A plan dict as serialized before ``prefix_budget_bytes`` existed."""
    if node is None:
        return
    pt = (node.get("detail") or {}).get("page_table")
    if pt is not None:
        pt.pop("prefix_budget_bytes", None)
    _strip(node.get("child"))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "deepseek-v2-236b"])
def test_prefix_budget_accessor_and_roundtrip(arch):
    hbm = 16 << 30
    plan = plan_decode(get_model_config(arch).reduced(), max_len=64,
                       batch=8, dtype_bytes=4,
                       spec=h100_spec(smem_bytes=16 << 10, hbm_bytes=hbm))
    ref = ref_plan_decode(ref_config(arch).reduced(), make_host_mesh(),
                          max_len=64, batch=8, dtype_bytes=4,
                          spec=chip_spec(vmem_bytes=16 << 10,
                                         vmem_reserved_bytes=0,
                                         hbm_bytes=hbm))
    ptab = plan.page_table()
    budget = plan.prefix_budget()
    assert budget == ptab["prefix_budget_bytes"] > 0
    assert budget == ref.prefix_budget()
    # The HBM leftover after the replicated reserve, times kv_shard.
    free = hbm - plan.level("NVLINK").detail["replicated_bytes"]
    assert budget == free * plan.kv_shard()
    rt = HierarchicalPlan.from_json(plan.to_json())
    assert rt == plan and rt.prefix_budget() == budget
    d = rt.to_dict()
    _strip(d)
    legacy = HierarchicalPlan.from_dict(d)
    page = legacy.page_plan()
    expect = (legacy.page_table()["pages_total"] * page["page_tokens"]
              * page["tok_bytes"] * page["layers"] * page["kv_shard"])
    assert legacy.prefix_budget() == expect
    # The reference's fallback reads the port's legacy plan the same way,
    # and the port reads the reference's legacy plan (the reason the
    # fallback exists: plans the JAX package wrote before the field).
    ref_d = ref.to_dict()
    _strip(ref_d)
    assert type(ref).from_dict(ref_d).prefix_budget() == expect
    assert HierarchicalPlan.from_dict(ref_d).prefix_budget() == expect


def test_xlstm_prefix_budget_is_none():
    """Token-free families have no page level: the accessor returns None
    (the engine then budgets the tree by its KV budget)."""
    plan = plan_decode(get_model_config("xlstm-1.3b").reduced(), max_len=64,
                       batch=1, dtype_bytes=4)
    assert plan.page_table() is None and plan.prefix_budget() is None
