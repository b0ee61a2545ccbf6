"""The port's persistent radix session across ``generate`` calls, against
cold runs and the JAX package's engines.

* A second call's request hits a prefix the first call published (the
  reference's persistence test), also when the calls differ in size.
* A fully cached prompt caps its hit at ``prompt_len - 1`` and CoWs its
  last page; its tokens equal the JAX cohort engine's (the prompt ends on
  a page boundary, where the JAX paged engine loses the first decode
  token's K/V: ROADMAP Queue 3).
* Pages exported from one engine and imported into another make the
  second engine's next request hit the whole page-aligned prefix, with the
  first engine's tokens (dense, the MLA latent pool, and zamba2's state
  snapshots).
* Under pool pressure, cached pages are evicted for live slots and the
  tokens stay the cold run's.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServePolicy as RefPolicy
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import ServeEngine, ServePolicy

LEAF = 16 << 10
SPEC = h100_spec(smem_bytes=LEAF)


def _engine(cfg, prefix="radix", params=None, **pol):
    pol = dict(dict(max_new_tokens=4, max_len=136, max_slots=1,
                    batching="paged"), **pol)
    return ServeEngine(cfg, ServePolicy(prefix_cache=prefix, **pol),
                       params=params, spec=SPEC, device="cpu")


def _two_sharing(cfg, shared_tokens, tail_tokens, rng):
    shared = rng.integers(0, cfg.vocab_size, shared_tokens, dtype=np.int32)
    tails = [rng.integers(0, cfg.vocab_size, tail_tokens, dtype=np.int32)
             for _ in range(2)]
    tails[1][0] = (tails[0][0] + 1) % cfg.vocab_size
    return [np.concatenate([shared, t]) for t in tails]


def test_prefix_cache_persists_across_generate_calls():
    cfg = get_model_config("llama3.2-1b").reduced()
    eng = _engine(cfg)
    t = eng.page.page_tokens
    a, b = _two_sharing(cfg, 3 * t, t - 2, np.random.default_rng(0xBEEF))
    out_a = eng.generate([a])
    assert eng.metrics["prefix_hits"] == 0
    out_b = eng.generate([b])
    assert eng.metrics["prefix_hits"] == 1
    assert eng.metrics["prefix_hit_tokens"] == 3 * t
    cold = _engine(cfg, "off", params=eng.params)
    assert cold.generate([a]) == out_a
    assert cold.generate([b]) == out_b


def test_session_persists_across_calls_of_different_sizes():
    """One request publishes the prefix (its third page completes); a
    later call of three requests on the same engine hits it three times,
    each a CoW of that page (the session has ``max_slots`` slots whatever
    the call's size)."""
    cfg = get_model_config("llama3.2-1b").reduced()
    eng = _engine(cfg, max_slots=4)
    t = eng.page.page_tokens
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 2 * t + 3, dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, t + i, dtype=np.int32)]) for i in range(4)]
    eng.generate(prompts[:1], max_new_tokens=1)
    outs = eng.generate(prompts[1:])
    assert eng.metrics["prefix_hits"] == 3
    assert eng.metrics["cow_copies"] == 3
    assert eng.stats()["used_pages"] == eng.stats()["prefix_pages"]
    cold = _engine(cfg, "off", params=eng.params, max_slots=4)
    assert cold.generate(prompts[1:]) == outs


def test_identical_prompt_rehit_cows_final_page():
    """A fully cached prompt still computes its last token: the hit caps
    at ``prompt_len - 1`` and CoWs the final page.  The tokens equal the
    JAX cohort engine's on the same parameters."""
    rcfg = ref_config("llama3.2-1b").reduced()
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    ref = RefEngine(rcfg, Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                               ("data", "model")),
                    policy=RefPolicy(max_new_tokens=4, max_len=136,
                                     batching="cohort"), spec=ref_spec)
    cfg = get_model_config("llama3.2-1b").reduced()
    eng = _engine(cfg, params=params_from_numpy(
        jax.tree.map(np.asarray, ref.params), cfg, "cpu"))
    t = eng.page.page_tokens
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 3 * t,
                                               dtype=np.int32)
    out1 = eng.generate([prompt])
    out2 = eng.generate([prompt])
    assert out1 == out2 == ref.generate([prompt])
    m = eng.metrics
    assert m["prefix_hits"] == 1
    assert m["prefix_hit_tokens"] == 3 * t - 1
    assert m["cow_copies"] == 1
    assert m["prefill_tokens"] == 3 * t + 1


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b",
                                  "zamba2-1.2b"])
def test_export_then_import_between_two_engines(arch):
    cfg = get_model_config(arch).reduced()
    src = _engine(cfg, max_len=256)
    dst = _engine(cfg, params=src.params, max_len=256)
    t = src.page.page_tokens
    a, b = _two_sharing(cfg, 2 * t + t // 2, t // 2 + 2,
                        np.random.default_rng(11))
    assert dst.export_pages(a) is None            # nothing cached yet
    src.generate([a], max_new_tokens=1)
    payload = src.export_pages(b)
    covered = 2 * t                               # b's page-aligned share
    assert payload["tokens"] == b[:covered].tolist()
    assert payload["page_tokens"] == t and len(payload["pages"]) == 2
    names = set(src._paged_session.cache["pool"])
    for page in payload["pages"]:
        assert set(page) == names
        for arr in page.values():
            assert isinstance(arr, np.ndarray) and arr.shape[1] == t
    if cfg.family == "hybrid_ssm":
        assert sorted(payload["snaps"]) == [t, 2 * t]
        snap = payload["snaps"][2 * t]["mamba"]
        assert isinstance(snap["ssm"], np.ndarray)
    else:
        assert payload["snaps"] == {}
    got = dst.import_pages(payload["tokens"], payload["pages"],
                           payload["snaps"])
    assert got == covered
    assert dst.stats()["prefix_pages"] == 2
    outs = dst.generate([b])
    assert dst.metrics["prefix_hits"] == 1
    assert dst.metrics["prefix_hit_tokens"] == covered
    assert dst.metrics["prefill_tokens"] == len(b) - covered
    assert outs == src.generate([b])
    assert outs == _engine(cfg, "off", params=src.params,
                           max_len=256).generate([b])


def test_import_needs_the_radix_cache():
    cfg = get_model_config("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="radix"):
        _engine(cfg, "off").import_pages([1, 2, 3], [])
    whisper = get_model_config("whisper-large-v3").reduced()
    with pytest.raises(ValueError, match="prefix-cacheable"):
        _engine(whisper).import_pages([1, 2, 3], [])


def test_pool_pressure_evicts_cached_pages_and_keeps_the_tokens():
    """A pool of four pages for one slot: every request publishes its
    prompt pages, and the next one's allocations evict them (LRU) instead
    of failing; the tokens stay the cold run's."""
    cfg = get_model_config("llama3.2-1b").reduced()
    probe = _engine(cfg, "off")
    t = probe.page.page_tokens
    pol = dict(max_len=4 * t, kv_budget_bytes=4 * probe.page.page_bytes)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 2 * t + 5, dtype=np.int32)
               for _ in range(3)]
    warm = _engine(cfg, params=probe.params, **pol)
    outs = [warm.generate([p]) for p in prompts]
    assert warm.metrics["pages_total"] == 4
    assert warm.metrics["prefix_evicted_pages"] > 0
    cold = _engine(cfg, "off", params=probe.params, **pol)
    assert outs == [cold.generate([p]) for p in prompts]
    pool = warm._paged_session.pool
    pool.assert_reconciled()
    assert pool.total_refs == warm.stats()["prefix_pages"]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_snapshots_of_long_concurrent_prefills_stay_within_the_state_budget(
        arch):
    """Four slots prefill prompts of 12 pages at once under a snapshot cap
    of 6 snapshots: every snapshot is billed before it is cloned, so the
    snapshots alive on the device (counted by reference, independent of
    the tree's own accounting) never exceed the cap; the tree fills to it,
    and the tokens stay the cold run's."""
    import weakref

    cfg = get_model_config(arch).reduced()
    pol = dict(max_slots=4, max_len=256, max_new_tokens=2)
    rng = np.random.default_rng(0x5A7E)
    probe = _engine(cfg, **pol)
    t = probe.page.page_tokens
    probe.generate([rng.integers(0, cfg.vocab_size, t + 3, dtype=np.int32)])
    sess = probe._paged_session
    snap = sess.prefix.state_bytes // sess.prefix.n_nodes
    held = probe.budget_bytes - sess.prefix.state_budget_bytes
    warm = _engine(cfg, params=probe.params,
                   kv_budget_bytes=held + 6 * snap, **pol)
    cold = _engine(cfg, prefix="off", params=probe.params, **pol)
    live, peak = [], [0]
    snapshot = warm._snapshot

    def tracked(cache, slot, clone=True):
        out = snapshot(cache, slot, clone)
        if clone:
            live[:] = [r for r in live if r() is not None]
            rows = next(iter(next(iter(out.values())).values()))
            live.append(weakref.ref(rows))
            peak[0] = max(peak[0], len(live))
        return out

    warm._snapshot = tracked
    prompts = [rng.integers(0, cfg.vocab_size, 12 * t + 5, dtype=np.int32)
               for _ in range(4)]
    assert warm.generate(prompts) == cold.generate(prompts)
    prefix = warm._paged_session.prefix
    assert warm._paged_session.key == sess.key      # the pool is unchanged
    cap = prefix.state_budget_bytes
    assert 6 * snap <= cap < 7 * snap
    assert 0 < peak[0] * snap <= cap
    assert prefix.peak_state_bytes <= cap
    assert warm.metrics["prefix_peak_state_bytes"] <= cap
    assert cap - snap < prefix.state_bytes <= cap   # filled to its budget
    assert warm.stats()["prefix_state_bytes"] == prefix.state_bytes
    # A later request sharing a cached prefix still hits, with the cold
    # run's tokens.
    again = np.concatenate([prompts[-1][:2 * t], prompts[0][:t // 2 + 1]])
    hits = warm.metrics["prefix_hits"]
    assert warm.generate([again]) == cold.generate([again])
    assert warm.metrics["prefix_hits"] == hits + 1
    assert prefix.peak_state_bytes <= cap
