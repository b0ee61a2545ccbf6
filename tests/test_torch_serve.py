"""The port's paged ``ServeEngine`` against the JAX package's, and its own
bookkeeping.

Greedy decode on the trace of ``tests/test_serve_paged.py`` (mixed prompt
lengths and max_new, two slots, a backfill) is token-identical between the
JAX paged engine (interpret-mode Pallas kernel) and the port on the CPU,
with the same parameters and the same page geometry.
"""

import jax
import numpy as np
import pytest
import torch
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
from repro_torch.serve import SamplingConfig, ServeEngine, ServePolicy
from repro_torch.serve.kvcache import PageSpec
from repro_torch.serve.pages import PagedScheduler, PagePool
from repro_torch.serve.scheduler import Request

LENS = (8, 12, 8)
NEWS = [6, 3, 2]
#: The same tiny leaf (and the same HBM) on both sides, so pages are small,
#: several requests share the pool, and both plans size the same pool.
LEAF = 16 << 10


def _host_mesh():
    """The JAX engine's one-device ("data", "model") mesh, with automatic
    axes: newer jax makes ``jax.make_mesh`` axes explicit by default, and
    the JAX model's sharding constraints only take automatic ones."""
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _pair(prefill="chunked"):
    rcfg = ref_config("llama3.2-1b").reduced()
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    ref = RefEngine(rcfg, _host_mesh(),
                    policy=RefPolicy(max_new_tokens=4, max_len=64,
                                     max_slots=2, batching="paged",
                                     prefill=prefill),
                    spec=ref_spec)
    cfg = get_model_config("llama3.2-1b").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                               "cpu")
    mine = ServeEngine(cfg, ServePolicy(max_new_tokens=4, max_len=64,
                                        max_slots=2, batching="paged",
                                        prefill=prefill),
                       params=params,
                       spec=h100_spec(smem_bytes=LEAF,
                                      hbm_bytes=ref_spec.hbm_bytes),
                       device="cpu")
    return cfg, ref, mine


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in LENS]


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_greedy_tokens_identical_to_jax_paged_engine(prefill):
    cfg, ref, mine = _pair(prefill)
    prompts = _prompts(cfg)
    outs_ref = ref.generate(prompts, max_new_tokens=NEWS)
    outs = mine.generate(prompts, max_new_tokens=NEWS)
    assert outs == outs_ref
    assert [len(o) for o in outs] == NEWS
    # Pinned to the same page and pool geometry.
    for key in ("page_tokens", "pages_total", "pages_per_slot",
                "prefill_chunks", "decode_steps", "backfills",
                "pages_allocated", "pages_released"):
        assert mine.metrics[key] == ref.metrics[key], key
    assert mine.plan.page_table() == {
        k: ref.plan.page_table()[k]
        for k in ("pages_per_slot", "pages_total", "slots_bound")}
    assert mine.metrics["backfills"] >= 1
    assert mine.metrics["pages_allocated"] == mine.metrics["pages_released"]
    assert mine.metrics["tokens"] == sum(NEWS)
    assert mine.stats()["used_pages"] == 0


def test_preemption_under_a_tiny_pool_completes():
    """Three usable pages for two growing slots: the older slot preempts
    the younger (recompute), which requeues and still finishes; the pool
    drains clean."""
    cfg = get_model_config("llama3.2-1b").reduced()
    probe = ServeEngine(cfg, ServePolicy(max_len=128),
                        spec=h100_spec(smem_bytes=LEAF), device="cpu")
    t = probe.page.page_tokens
    engine = ServeEngine(
        cfg, ServePolicy(max_len=4 * t, max_slots=2,
                         kv_budget_bytes=probe.page.page_bytes * 3),
        params=probe.params, spec=h100_spec(smem_bytes=LEAF), device="cpu")
    rng = np.random.default_rng(0)
    deep, shallow = 3 * t - 8, 2 * t - 8
    outs = engine.generate(
        [rng.integers(0, 256, 8, dtype=np.int32) for _ in range(2)],
        max_new_tokens=[deep, shallow])
    assert [len(o) for o in outs] == [deep, shallow]
    assert engine.metrics["evictions"] >= 1
    assert engine.metrics["stalls"] >= 1
    assert engine.metrics["pages_allocated"] == \
        engine.metrics["pages_released"]


def test_no_device_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = get_model_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, device="cuda")


def test_unported_paths_raise():
    """The prefix cache still raises; the cohort engine and the vlm family
    are served (the vlm falls back from paged to cohort)."""
    cfg = get_model_config("llama3.2-1b").reduced()
    with pytest.raises(NotImplementedError, match="prefix"):
        ServeEngine(cfg, ServePolicy(prefix_cache="radix"), device="cpu")
    assert ServeEngine(cfg, ServePolicy(batching="cohort"),
                       device="cpu").batching == "cohort"
    assert ServeEngine(get_model_config("qwen2-vl-7b").reduced(),
                       device="cpu").batching == "cohort"
    for arch in ("mixtral-8x7b", "xlstm-1.3b", "deepseek-v2-236b",
                 "whisper-large-v3"):                 # served: no raise
        ServeEngine(get_model_config(arch).reduced(), device="cpu")


def test_seeded_top_k_sampling_replays_and_stays_in_the_top_k():
    cfg = get_model_config("llama3.2-1b").reduced()
    scfg = SamplingConfig(kind="top_k", top_k=3, seed=11)
    engine = ServeEngine(cfg, ServePolicy(max_len=64, max_slots=2),
                         spec=h100_spec(smem_bytes=LEAF), device="cpu")
    prompts = _prompts(cfg)
    a = engine.generate(prompts, max_new_tokens=NEWS, sampling=scfg)
    b = engine.generate(prompts, max_new_tokens=NEWS, sampling=scfg)
    assert a == b
    greedy = engine.generate(prompts, max_new_tokens=NEWS)
    assert a != greedy              # the draws are not all argmax
    from repro_torch.serve.sampling import make_generator, sample
    logits = torch.randn(64, cfg.vocab_size,
                         generator=torch.Generator().manual_seed(0))
    toks = sample(logits, scfg, make_generator(scfg, "cpu"))
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert (top3 == toks[:, None]).any(dim=-1).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), n_slots=st.integers(1, 3),
       pages=st.integers(2, 9))
def test_scheduler_page_flow_reconciles(seed, n_slots, pages):
    """Random admit / grow / preempt / finish sequences: the pool's flow
    counters, free list and refcounts reconcile after every operation, and
    slot tables never hold more pages than the pool handed out."""
    rng = np.random.default_rng(seed)
    page = PageSpec(page_tokens=4, token_bytes=8)
    pool = PagePool(pages + 1)
    sched = PagedScheduler(pool, page, n_slots, pages_per_slot=4)
    for rid in range(6):
        sched.submit(Request(rid=rid, prompt_len=int(rng.integers(1, 9)),
                             max_new=3))
    for _ in range(60):
        if not sched.has_work():
            break
        sched.admit()
        active = sched.active()
        if active:
            i = int(rng.choice(active))
            op = rng.integers(0, 3)
            if op == 0 and not sched.ensure_capacity(
                    i, upto=sched.slots[i].pos + int(rng.integers(1, 6))):
                victim = sched.victim(i)
                if victim is not None:
                    sched.evict(victim)
            elif op == 1:
                sched.slots[i].pos += 1
            else:
                sched.finish(i)
        pool.assert_reconciled()
        assert pool.used_pages == sched.used_pages_by_slots()
    for i in sched.active():
        sched.finish(i)
    pool.assert_reconciled()
    assert pool.used_pages == 0
    assert pool.pages_allocated == pool.pages_released


def test_state_rows_take_the_slot_axis_of_each_buffer(monkeypatch):
    """A state group holding a per-slot vector (S,) beside a layer-stacked
    buffer (L, S, X): the engine's save and restore of frozen slots and
    ``reset_slot`` take the slot on axis 0 of the vector and axis 1 of the
    stacked buffer, as the reference's engine does, and touch no other
    slot."""
    from repro_torch.models.model import Model
    from repro_torch.serve import pages

    cfg = get_model_config("llama3.2-1b").reduced()

    def init_state(self, n_slots, dtype, device):
        return {"g": {"vec": torch.full((n_slots,), 7.0, device=device),
                      "stack": torch.full((2, n_slots, 3), 5.0,
                                          device=device)}}

    monkeypatch.setattr(Model, "init_state", init_state)
    monkeypatch.setitem(pages.STATE_GROUPS, cfg.family, ("g",))
    gen = torch.Generator().manual_seed(0)
    vec, stack = torch.randn(4, generator=gen), torch.randn(2, 4, 3,
                                                             generator=gen)
    cache = {"pos": torch.zeros(4, dtype=torch.int32),
             "state": {"g": {"vec": vec.clone(), "stack": stack.clone()}}}

    # Save the frozen slots' rows, let a step overwrite every row, restore.
    rows = torch.tensor([1, 3])
    saved = {k: pages.slot_rows(b, rows)
             for k, b in cache["state"]["g"].items()}
    assert saved["vec"].shape == (2,) and saved["stack"].shape == (2, 2, 3)
    for b in cache["state"]["g"].values():
        b.fill_(-1.0)
    for k, b in cache["state"]["g"].items():
        pages.set_slot_rows(b, rows, saved[k])
    got = cache["state"]["g"]
    torch.testing.assert_close(got["vec"][rows], vec[rows])
    torch.testing.assert_close(got["stack"][:, rows], stack[:, rows])
    assert (got["vec"][[0, 2]] == -1).all()
    assert (got["stack"][:, [0, 2]] == -1).all()

    # Reset slot 2 to the initial values; the others keep theirs.
    before = {k: b.clone() for k, b in got.items()}
    pages.reset_slot(cfg, cache, 2)
    assert float(got["vec"][2]) == 7.0 and (got["stack"][:, 2] == 5.0).all()
    keep = [0, 1, 3]
    torch.testing.assert_close(got["vec"][keep], before["vec"][keep])
    torch.testing.assert_close(got["stack"][:, keep],
                               before["stack"][:, keep])
