"""The port's paged ``ServeEngine`` on the moe family (Mixtral, sliding
window 32 at ``reduced()``) against the JAX package's, and its window
page reclaim.

Greedy decode of ``mixtral-8x7b.reduced()`` is token-identical between the
JAX paged engine and the port on the CPU, with the same parameters and
page geometry, under chunked and monolithic prefill, on a trace with a
backfill and a prompt longer than the window; pages wholly below the
window are freed while the request still runs.  A prompt four windows long
admits under a pool that holds only its resident window, and preemption
under a tiny pool leaves the tokens unchanged.  Traces stay moderate:
near-tied logits could flip a greedy token under another summation order
(``tests/test_serve_paged.py``).
"""

import dataclasses

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

ARCH = "mixtral-8x7b"
#: The 40-token prompt runs past the 32-token window.
LENS = (8, 40, 12)
NEWS = [6, 3, 2]
#: The same tiny leaf (and the same HBM) on both sides: small pages.
LEAF = 16 << 10


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _synchronous(ref):
    """``ref``'s paged steps wait for their results.  On the CPU, jax
    0.9.0's ``jnp.asarray`` shares a numpy array's memory, and the JAX
    paged engine rewrites its host page table and positions while a step
    it dispatched may still read them: on a loaded host its tokens then
    vary from process to process.  Waiting is what the CPU backend does
    with ``jax_cpu_enable_async_dispatch`` off."""
    make = ref._paged_steps

    def blocking(step):
        return lambda *args: jax.block_until_ready(step(*args))

    def paged_steps(*args, **kw):
        steps = make(*args, **kw)
        return dataclasses.replace(
            steps, decode=blocking(steps.decode),
            prefill_chunk=blocking(steps.prefill_chunk))

    ref._paged_steps = paged_steps
    return ref


def _pair(leaf, **pol):
    """The JAX paged engine and the port's, on the same parameters, leaf
    and policy."""
    rcfg = ref_config(ARCH).reduced()
    ref_spec = chip_spec(vmem_bytes=leaf, vmem_reserved_bytes=0)
    ref = _synchronous(RefEngine(rcfg, _host_mesh(),
                                 policy=RefPolicy(batching="paged", **pol),
                                 spec=ref_spec))
    cfg = get_model_config(ARCH).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(batching="paged", **pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=leaf, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    return cfg, ref, mine


def _freed_while_running(engine) -> bool:
    """A page went back to the pool before the request that held it ended
    (one request: only window reclaim frees pages mid-flight)."""
    events = engine.tracer.export_events()
    end = max(e["ts"] + e["dur"] for e in events if e["name"] == "request")
    return any(e["name"] == "page_free" and e["ts"] < end for e in events)


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_greedy_tokens_identical_to_jax_paged_engine(prefill):
    cfg, ref, mine = _pair(LEAF, max_new_tokens=4, max_len=64, max_slots=2,
                           prefill=prefill)
    assert cfg.sliding_window == 32 and max(LENS) > cfg.sliding_window
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in LENS]
    outs_ref = ref.generate(prompts, max_new_tokens=NEWS)
    outs = mine.generate(prompts, max_new_tokens=NEWS)
    assert outs == outs_ref
    assert [len(o) for o in outs] == NEWS
    for key in ("page_tokens", "pages_total", "pages_per_slot",
                "prefill_chunks", "decode_steps", "backfills",
                "pages_allocated", "pages_released", "peak_pages"):
        assert mine.metrics[key] == ref.metrics[key], key
    assert list(mine.metrics["interleave"]) == list(ref.metrics["interleave"])
    assert mine.metrics["backfills"] >= 1
    assert mine.metrics["pages_allocated"] == mine.metrics["pages_released"]


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_window_overflow_prompt_and_reclaim(prefill):
    """The reference's ``test_paged_window_overflow_prompt_and_reclaim``,
    against the JAX paged engine: a prompt 8 tokens past the window, and
    16 new tokens (the reference's 8 end before the first 16-token page
    leaves the window); identical tokens, and the page below the window
    freed while the request still runs."""
    pol = dict(max_len=96, max_slots=1, prefill=prefill)
    cfg, ref, mine = _pair(8 << 10, **pol)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, cfg.sliding_window + 8,
                            dtype=np.int32)]
    outs_ref = ref.generate(prompts, max_new_tokens=[16])
    outs = mine.generate(prompts, max_new_tokens=[16])
    assert outs == outs_ref
    assert mine.metrics["pages_released"] == \
        mine.metrics["pages_allocated"] == ref.metrics["pages_allocated"]
    assert mine.metrics["pages_released"] > 0
    assert _freed_while_running(mine)


def test_windowed_prompt_billed_for_resident_window_only():
    """The reference's test of the same name: a prompt four windows long
    admits under a pool that holds only the resident window (pages below
    the window are reclaimed behind the chunk front), and its tokens equal
    an unconstrained pool's with whole-prompt prefill, and the JAX cohort
    engine's.  (The prompt ends on a page boundary, where the JAX paged
    engine writes the first decode token's K/V to the null page: its
    tokens part from the third on.)"""
    cfg = get_model_config(ARCH).reduced()
    spec = h100_spec(smem_bytes=8 << 10)
    probe = ServeEngine(cfg, ServePolicy(max_len=160), spec=spec,
                        device="cpu")
    t = probe.page.page_tokens
    plen = 4 * cfg.sliding_window
    budget = probe.page.page_bytes * (cfg.sliding_window // t + 2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32)]
    _, ref, tight = _pair(8 << 10, max_len=plen + 16, max_slots=1,
                          kv_budget_bytes=budget)
    outs = tight.generate(prompts, max_new_tokens=[6])
    big = ServeEngine(cfg, ServePolicy(prefill="monolithic",
                                       max_len=plen + 16, max_slots=1),
                      params=tight.params, spec=spec, device="cpu")
    assert outs == big.generate(prompts, max_new_tokens=[6])
    assert plen % t == 0
    cohort = RefEngine(ref.cfg, _host_mesh(),
                       policy=RefPolicy(batching="cohort",
                                        max_len=plen + 16, max_slots=1),
                       params=ref.params)
    assert outs == cohort.generate(prompts, max_new_tokens=[6])
    assert tight.metrics["peak_pages"] <= cfg.sliding_window // t + 2
    assert big.metrics["peak_pages"] > tight.metrics["peak_pages"]
    assert _freed_while_running(tight)


def test_windowed_prompt_off_a_page_boundary_equals_jax_paged_engine():
    """The tight-pool case above with a prompt 3 tokens short of four
    windows, which ends inside a page: the port's paged engine and the JAX
    paged engine give the same tokens under the same resident-window
    pool, and pages leave the window while the request runs."""
    cfg = get_model_config(ARCH).reduced()
    spec = h100_spec(smem_bytes=8 << 10)
    probe = ServeEngine(cfg, ServePolicy(max_len=160), spec=spec,
                        device="cpu")
    t = probe.page.page_tokens
    plen = 4 * cfg.sliding_window - 3
    assert plen % t
    budget = probe.page.page_bytes * (cfg.sliding_window // t + 2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32)]
    _, ref, tight = _pair(8 << 10, max_len=plen + 16, max_slots=1,
                          kv_budget_bytes=budget)
    outs = tight.generate(prompts, max_new_tokens=[6])
    assert outs == ref.generate(prompts, max_new_tokens=[6])
    assert tight.metrics["peak_pages"] <= cfg.sliding_window // t + 2
    assert _freed_while_running(tight)


@pytest.mark.parametrize("news,evicts", [
    ((3, 2), True),       # the older slot's growth evicts the younger
    ((1.25, 2), False),   # the older ends within its pages: the younger
                          # stalls, then resumes
])
def test_preemption_under_a_tiny_pool_keeps_the_tokens(news, evicts):
    """Three usable 16-token pages for two growing slots, whose pages
    below the 32-token window are reclaimed as they grow: the older slot
    preempts (recompute) or stalls the younger one, every request still
    finishes, the tokens equal an unconstrained pool's and the pool drains
    clean."""
    cfg = get_model_config(ARCH).reduced()
    spec = h100_spec(smem_bytes=8 << 10)
    probe = ServeEngine(cfg, ServePolicy(max_len=128), spec=spec,
                        device="cpu")
    t = probe.page.page_tokens
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
               for _ in range(2)]
    news = [int(f * t) - 8 for f in news]
    free = ServeEngine(cfg, ServePolicy(max_len=4 * t, max_slots=2),
                       params=probe.params, spec=spec, device="cpu")
    tight = ServeEngine(
        cfg, ServePolicy(max_len=4 * t, max_slots=2,
                         kv_budget_bytes=probe.page.page_bytes * 3),
        params=probe.params, spec=spec, device="cpu")
    outs = tight.generate(prompts, max_new_tokens=news)
    assert outs == free.generate(prompts, max_new_tokens=news)
    assert [len(o) for o in outs] == news
    assert tight.metrics["stalls"] >= 1
    assert (tight.metrics["evictions"] >= 1) == evicts
    assert tight.metrics["pages_allocated"] == \
        tight.metrics["pages_released"]
