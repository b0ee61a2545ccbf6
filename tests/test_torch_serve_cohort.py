"""The port's cohort ``ServeEngine`` against the JAX package's, and its own
bookkeeping.

Greedy decode of every family's ``reduced()`` config is token-identical
between the JAX cohort engine and the port's on the CPU, with the same
parameters and page geometry: dense (llama3.2-1b), vlm (qwen2-vl-7b with
patch ``embeds`` and ``positions_3d``; a text-only prompt's ``tokens``
decode as their embedding rows), moe
(mixtral-8x7b on a trace whose 40-token prompt and 30 new tokens wrap the
32-token ring), mla_moe, hybrid_ssm, xlstm and enc_dec.  On the trace of
``tests/test_serve_paged.py`` the port's cohort and paged engines give
the same tokens and the paged one the higher slot utilization.  Under a
tiny budget the cohort cache grows page by page, compacts finished slots
and evicts the younger cohort, as ``tests/test_serve_engine.py`` holds the
reference to; the scheduler's budget invariant holds over random
admit/grow/finish/evict sequences; ``"auto"`` and the vlm fallback pick
the reference's engine.  Traces stay moderate: near-tied logits could flip
a greedy token under another summation order.
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServePolicy as RefPolicy
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import ServeEngine, ServePolicy
from repro_torch.serve.kvcache import PageSpec, kv_token_bytes
from repro_torch.serve.scheduler import Request, ServeScheduler

#: The trace of tests/test_serve_paged.py: mixed prompt lengths and
#: max_new, two slots (a cohort drags its early finisher; the paged engine
#: backfills).
LENS = (8, 12, 8)
NEWS = [6, 3, 2]
#: The same tiny leaf (and the same HBM) on both sides: small pages, so
#: the cohort caches grow.
LEAF = 16 << 10


def _host_mesh():
    """The JAX engine's one-device ("data", "model") mesh with automatic
    axes (the JAX model's sharding constraints only take those)."""
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _pair(arch, **pol):
    """The JAX cohort engine and the port's, on the same parameters, leaf
    and policy."""
    pol = dict(dict(max_new_tokens=4, max_len=64, max_slots=2), **pol)
    rcfg = ref_config(arch).reduced()
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    ref = RefEngine(rcfg, _host_mesh(),
                    policy=RefPolicy(batching="cohort", **pol),
                    spec=ref_spec)
    cfg = get_model_config(arch).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(batching="cohort", **pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=LEAF, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    return cfg, ref, mine


def _token_prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in lens]


def _vlm_prompts(cfg, seed=0):
    """A 4 x 4 patch grid then 4 text rows (positions (0, row, col), then
    4..7 on all three streams), the same shape again, and 8 rows without
    ``positions_3d`` (they default to arange on all three streams).  (The
    JAX engine's prefill takes a vlm cohort's rows as ``embeds`` only.)"""
    rng = np.random.default_rng(seed)
    grid = np.arange(16)
    pos = np.concatenate([
        np.stack([np.zeros(16), grid // 4, grid % 4]),
        np.tile(np.arange(4, 8), (3, 1))], axis=1).astype(np.int32)
    img = [{"embeds": (rng.standard_normal((20, cfg.d_model)) * 0.5
                       ).astype(np.float32), "positions_3d": pos}
           for _ in range(2)]
    return img + [{"embeds": (rng.standard_normal((8, cfg.d_model)) * 0.5
                              ).astype(np.float32)}]


def _encdec_prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [{"enc_embeds": (rng.standard_normal((se, cfg.d_model)) * 0.02
                            ).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, n, dtype=np.int32)}
            for se, n in ((10, 8), (10, 8), (6, 12))]


#: arch -> (prompts(cfg), max_new per request)
TRACES = {
    "llama3.2-1b": (lambda c: _token_prompts(c, LENS), NEWS),
    "qwen2-vl-7b": (_vlm_prompts, [6, 3, 5]),
    "mixtral-8x7b": (lambda c: _token_prompts(c, (40, 40, 12)), [30, 4, 6]),
    "deepseek-v2-236b": (lambda c: _token_prompts(c, LENS), NEWS),
    "zamba2-1.2b": (lambda c: _token_prompts(c, LENS), NEWS),
    "xlstm-1.3b": (lambda c: _token_prompts(c, LENS), NEWS),
    "whisper-large-v3": (_encdec_prompts, [6, 3, 4]),
}


@pytest.mark.parametrize("arch", list(TRACES))
def test_greedy_tokens_identical_to_jax_cohort_engine(arch):
    cfg, ref, mine = _pair(arch)
    make, news = TRACES[arch]
    prompts = make(cfg)
    outs_ref = ref.generate(prompts, max_new_tokens=news)
    outs = mine.generate(prompts, max_new_tokens=news)
    assert outs == outs_ref, arch
    assert [len(o) for o in outs] == news
    assert mine.metrics["batching"] == "cohort"
    for key in ("cohorts", "decode_steps", "evictions", "slot_steps",
                "active_slot_steps", "capacities", "peak_resident_bytes",
                "pages_allocated", "pages_released", "tokens"):
        assert mine.metrics[key] == ref.metrics[key], (arch, key)
    assert mine.metrics["pages_allocated"] == mine.metrics["pages_released"]


def test_vlm_text_tokens_equal_their_embeddings():
    """A text-only vlm prompt given as ``tokens`` decodes as the same rows
    given as ``embeds`` (the embedding table's rows, positions defaulting
    to arange on all three streams)."""
    cfg = get_model_config("qwen2-vl-7b").reduced()
    engine = ServeEngine(cfg, ServePolicy(batching="cohort", max_len=64),
                         spec=h100_spec(smem_bytes=LEAF), device="cpu")
    toks = _token_prompts(cfg, (8, 8), seed=3)
    table = engine.params["embedding"].numpy()
    by_tokens = engine.generate(toks, max_new_tokens=5)
    by_embeds = engine.generate([{"embeds": table[t]} for t in toks],
                                max_new_tokens=5)
    assert by_tokens == by_embeds


def test_mixtral_trace_wraps_the_ring():
    """The moe trace's 40-token prompts prefill past the 32-token ring and
    decode 30 more tokens around it; its requests are billed their
    window-clamped extent up front and the cache never grows."""
    cfg, _, mine = _pair("mixtral-8x7b")
    make, news = TRACES["mixtral-8x7b"]
    prompts = make(cfg)
    reqs = [mine._make_request(p, n) for p, n in zip(prompts, news)]
    w = cfg.sliding_window
    assert [r.admit_tokens for r in reqs] == [w, w, 12 + 6 + 1]
    assert not mine._growable()
    mine.generate(prompts, max_new_tokens=news)
    assert mine.metrics["capacities"] == []      # a ring never grows
    assert mine.metrics["cohorts"] == 2


def test_cohort_and_paged_engines_agree_and_paged_is_busier():
    cfg = get_model_config("llama3.2-1b").reduced()
    spec = h100_spec(smem_bytes=LEAF)
    pol = dict(max_new_tokens=4, max_len=64, max_slots=2)
    cohort = ServeEngine(cfg, ServePolicy(batching="cohort", **pol),
                         spec=spec, device="cpu")
    paged = ServeEngine(cfg, ServePolicy(batching="paged", **pol),
                        params=cohort.params, spec=spec, device="cpu")
    prompts = _token_prompts(cfg, LENS)
    outs_c = cohort.generate(prompts, max_new_tokens=NEWS)
    outs_p = paged.generate(prompts, max_new_tokens=NEWS)
    assert outs_c == outs_p
    assert paged.metrics["backfills"] >= 1
    assert paged.metrics["slot_utilization"] > \
        cohort.metrics["slot_utilization"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_prompts_ending_on_a_page_boundary(arch):
    """Prompts of one and two whole pages: the paged engine's final chunk
    makes room for the slot's first decode token (whose write would
    otherwise land on the null page), so its tokens equal the cohort
    engine's, and the JAX cohort engine's."""
    cfg, ref, cohort = _pair(arch)
    t = cohort.page.page_tokens
    paged = ServeEngine(cfg, ServePolicy(batching="paged", max_len=64,
                                         max_slots=2),
                        params=cohort.params,
                        spec=h100_spec(smem_bytes=LEAF), device="cpu")
    assert paged.page.page_tokens == t
    prompts = _token_prompts(cfg, (t, 2 * t, t), seed=4)
    news = [6, 5, 4]
    want = ref.generate(prompts, max_new_tokens=news)
    assert cohort.generate(prompts, max_new_tokens=news) == want
    assert paged.generate(prompts, max_new_tokens=news) == want


def test_one_token_request_on_a_page_boundary_fits_its_prompt_pages():
    """A request of one new token retires at its first token and never
    decodes, so a prompt of two whole pages is served by a pool of exactly
    two pages, with the cohort engine's token."""
    cfg = get_model_config("llama3.2-1b").reduced()
    spec = h100_spec(smem_bytes=LEAF)
    cohort = ServeEngine(cfg, ServePolicy(batching="cohort", max_len=64),
                         spec=spec, device="cpu")
    t = cohort.page.page_tokens
    prompts = _token_prompts(cfg, (2 * t,), seed=5)
    paged = ServeEngine(cfg, ServePolicy(
        batching="paged", max_len=64, max_slots=1,
        kv_budget_bytes=2 * cohort.page.page_bytes),
        params=cohort.params, spec=spec, device="cpu")
    outs = paged.generate(prompts, max_new_tokens=[1])
    assert paged.metrics["pages_total"] == 2            # usable pages
    assert outs == cohort.generate(prompts, max_new_tokens=[1])
    assert len(outs[0]) == 1


def test_growth_and_eviction_under_pressure():
    """The cache grows page by page in whole pages; under a budget of 64
    tokens with one slot a cohort, the younger cohort is evicted and
    recomputed, every request completes, and the peak stays in budget."""
    cfg = get_model_config("llama3.2-1b").reduced()
    spec = h100_spec(smem_bytes=LEAF)
    rng = np.random.default_rng(0)
    engine = ServeEngine(cfg, ServePolicy(batching="cohort",
                                          max_new_tokens=40, max_len=64),
                         spec=spec, device="cpu")
    t = engine.page.page_tokens
    assert t < 64                                # the plan shrank the page
    outs = engine.generate([rng.integers(0, 256, 8, dtype=np.int32)])
    assert len(outs[0]) == 40
    caps = engine.metrics["capacities"]
    assert len(caps) > 1, "decode never grew the cache"
    assert all(c % t == 0 for c in caps)

    budget = kv_token_bytes(cfg, 4)[0] * 64
    engine = ServeEngine(cfg, ServePolicy(batching="cohort",
                                          max_new_tokens=30, max_len=64,
                                          max_slots=1,
                                          kv_budget_bytes=budget),
                         params=engine.params, spec=spec, device="cpu")
    outs = engine.generate([rng.integers(0, 256, 8, dtype=np.int32)
                            for _ in range(2)])
    assert [len(o) for o in outs] == [30, 30]
    assert engine.metrics["evictions"] >= 1
    assert engine.metrics["tokens_recomputed"] >= 1
    assert engine.metrics["peak_resident_bytes"] <= budget


def test_compaction_frees_finished_slots_at_growth():
    """An early finisher is sliced out at the next growth boundary; the
    survivor's tokens equal a solo run's (rows are independent) and the
    freed slot's pages never inflate the peak."""
    cfg = get_model_config("llama3.2-1b").reduced()
    spec = h100_spec(smem_bytes=LEAF)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 8, dtype=np.int32) for _ in range(2)]
    pol = ServePolicy(batching="cohort", max_new_tokens=30, max_len=64)
    solo = ServeEngine(cfg, pol, spec=spec, device="cpu")
    ref = solo.generate([prompts[1]])[0]
    engine = ServeEngine(cfg, pol, params=solo.params, spec=spec,
                         device="cpu")
    outs = engine.generate(prompts, max_new_tokens=[6, 30])
    assert [len(o) for o in outs] == [6, 30]
    assert outs[1] == ref
    assert len(engine.metrics["capacities"]) > 1
    final_cap = engine.metrics["capacities"][-1]
    assert engine.scheduler.peak_bytes <= \
        engine.page.page_bytes * (engine.page.pages_for(final_cap) + 2)


def test_auto_and_the_vlm_fallback_pick_the_reference_engine():
    spec = h100_spec(smem_bytes=LEAF)
    vlm = get_model_config("qwen2-vl-7b").reduced()
    for batching in ("paged", "auto", "cohort"):
        assert ServeEngine(vlm, ServePolicy(batching=batching), spec=spec,
                           device="cpu").batching == "cohort"
    dense = get_model_config("llama3.2-1b").reduced()
    assert ServeEngine(dense, ServePolicy(batching="auto"), spec=spec,
                       device="cpu").batching == "paged"
    # The reference picks the same engines.
    rspec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    for arch, want in (("qwen2-vl-7b", "cohort"), ("llama3.2-1b", "paged")):
        ref = RefEngine(ref_config(arch).reduced(), _host_mesh(),
                        policy=RefPolicy(batching="auto"), spec=rspec)
        assert ref.batching == want


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), max_slots=st.integers(1, 3),
       budget_pages=st.integers(2, 12))
def test_scheduler_budget_invariant(seed, max_slots, budget_pages):
    """Random admit / reserve / finish / evict / compact sequences: the
    allocated bytes never exceed the budget, and the page flow reconciles
    after every operation."""
    rng = np.random.default_rng(seed)
    page = PageSpec(page_tokens=4, token_bytes=8)
    sched = ServeScheduler(budget_pages * page.page_bytes, page,
                           max_slots=max_slots)
    for rid in range(6):
        plen = int(rng.choice([3, 5, 9]))
        sched.submit(Request(rid=rid, prompt_len=plen, max_new=4,
                             state_bytes=int(rng.integers(0, 2)) * 8))
    for _ in range(60):
        if not sched.has_work():
            break
        try:
            sched.admit()
        except ValueError:
            break                       # a lone request cannot ever fit
        running = sched.running()
        if running:
            cid = int(rng.choice(running))
            c = sched._cohorts[cid]
            op = rng.integers(0, 4)
            if op == 0 and not sched.reserve(
                    cid, sched.capacity_tokens(cid) + page.page_tokens):
                victim = sched.youngest_other(cid)
                if victim is not None:
                    sched.evict(victim)
            elif op == 1:
                sched.finish(cid, c.reqs[0].rid)
            elif op == 2 and c.slots > 1:
                sched.shrink_slots(cid, [r.rid for r in c.reqs[1:]])
            elif op == 3:
                sched.evict(cid)
        assert sched.allocated_bytes <= sched.budget_bytes
        sched.assert_reconciled()
        assert sched.peak_bytes <= sched.budget_bytes
