"""The port's mla_moe family (DeepSeek-V2: one dense MLA layer, then MLA +
MoE layers with shared experts, over one latent page pool) against the JAX
package's: the model's paged steps and the paged ``ServeEngine``.

``deepseek-v2-236b.reduced()``'s prefill chunks (one slot across three
pages, another in one chunk) and decode step (one slot empty) give the
same logits and leave the same ``lat`` pool as the JAX model's.  Greedy
decode is token-identical between the JAX paged engine and the port on the
CPU, with the same parameters and page geometry, under chunked and
monolithic prefill, on a trace with a backfill; and under a pool so small
that the older slot preempts the younger, on both.

Tolerance: float32 1e-4 (two frameworks' float32 products differ in
summation order only).  Traces stay moderate: near-tied logits could flip
a greedy token under another summation order (``tests/test_serve_paged.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.models.model import build_model as ref_build
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServePolicy as RefPolicy
from repro.serve.pages import init_paged_cache as ref_init_cache
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import ServeEngine, ServePolicy
from repro_torch.serve.kvcache import request_state_bytes
from repro_torch.serve.pages import init_paged_cache

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-v2-236b"
LENS = (8, 21, 12)
NEWS = [6, 3, 2]
#: The same tiny leaf (and the same HBM) on both sides: small pages.
LEAF = 16 << 10


def test_prefill_chunks_then_decode_match():
    """Slot 0 prefills 20 tokens in chunks of 8, 8 and 4 (three pages),
    slot 2 one chunk of 6; then one decode step over all three slots (slot
    1 empty).  Logits after each call, and the ``lat`` pool, agree with the
    JAX model's; the family keeps no per-slot state."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    assert cfg.moe.first_k_dense == 1 and cfg.n_layers == 2
    params = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    ref_model, model = ref_build(rcfg, remat="none"), Model(cfg)
    t, p_total, n_logical = 8, 10, 4
    jcache = ref_init_cache(rcfg, ref_model, 3, p_total, t, n_logical,
                            jnp.float32)
    tcache = init_paged_cache(cfg, 3, p_total, t, n_logical, torch.float32,
                              "cpu")
    m = cfg.mla
    assert tuple(tcache["pool"]["lat"].shape) == \
        tuple(jcache["pool"]["lat"].shape) == \
        (cfg.n_layers, p_total, t, 1, m.kv_lora_rank + m.rope_head_dim)
    table = np.array([[2, 5, 7, 9], [0] * 4, [1, 3, 0, 0]], np.int32)
    jcache["table"], tcache["table"] = jnp.asarray(table), \
        torch.from_numpy(table)
    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, cfg.vocab_size, 20).astype(np.int32),
               2: rng.integers(0, cfg.vocab_size, 6).astype(np.int32)}

    def check_pool():
        np.testing.assert_allclose(tcache["pool"]["lat"].numpy(),
                                   np.asarray(jcache["pool"]["lat"]), **TOL)

    last = {}
    for slot, start, stop in ((0, 0, 8), (2, 0, 6), (0, 8, 16),
                              (0, 16, 20)):
        toks = prompts[slot][start:stop]
        lj, jcache = ref_model.prefill_chunk(
            params, jcache, {"tokens": jnp.asarray(toks)[None],
                             "pos0": jnp.int32(start),
                             "slot": jnp.int32(slot)}, dtype=jnp.float32)
        with torch.no_grad():
            lt, tcache = model.prefill_chunk(
                tparams, tcache, {"tokens": torch.from_numpy(toks)[None],
                                  "pos0": start, "slot": slot},
                dtype=torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        check_pool()
        last[slot] = int(np.argmax(lt.numpy()))
    assert tcache["state"] == {}

    pos = np.array([20, 0, 6], np.int32)
    toks = np.array([[last[0]], [0], [last[2]]], np.int32)
    jcache["pos"], tcache["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    lj, jcache = ref_model.decode_step_paged(
        params, jcache, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32)
    with torch.no_grad():
        lt, tcache = model.decode_step_paged(
            tparams, tcache, {"tokens": torch.from_numpy(toks)},
            dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    check_pool()
    np.testing.assert_array_equal(tcache["pos"].numpy(), pos + 1)


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _pair(leaf, **pol):
    """The JAX paged engine and the port's, on the same parameters, leaf
    and policy."""
    rcfg = ref_config(ARCH).reduced()
    ref_spec = chip_spec(vmem_bytes=leaf, vmem_reserved_bytes=0)
    ref = RefEngine(rcfg, _host_mesh(),
                    policy=RefPolicy(batching="paged", **pol), spec=ref_spec)
    cfg = get_model_config(ARCH).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(batching="paged", **pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=leaf, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    return cfg, ref, mine


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_greedy_tokens_identical_to_jax_paged_engine(prefill):
    cfg, ref, mine = _pair(LEAF, max_new_tokens=4, max_len=64, max_slots=2,
                           prefill=prefill)
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
    # The page's bytes are the latent's: (R + dr) values a token and layer.
    m = cfg.mla
    assert mine.page.page_bytes == mine.page.page_tokens * cfg.n_layers * \
        (m.kv_lora_rank + m.rope_head_dim) * 4


def test_preemption_under_a_tiny_pool_keeps_the_tokens():
    """Three usable pages for two growing slots: the older slot preempts
    the younger (recompute), which requeues and still finishes, on the JAX
    engine and the port alike; the tokens equal the JAX engine's under the
    same pool and the port's under an unconstrained one, and the pool
    drains clean."""
    cfg = get_model_config(ARCH).reduced()
    probe = ServeEngine(cfg, ServePolicy(max_len=128),
                        spec=h100_spec(smem_bytes=LEAF), device="cpu")
    t = probe.page.page_tokens
    budget = probe.page.page_bytes * 3
    _, ref, tight = _pair(LEAF, max_len=4 * t, max_slots=2,
                          kv_budget_bytes=budget)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
               for _ in range(2)]
    news = [3 * t - 8, 2 * t - 8]
    outs = tight.generate(prompts, max_new_tokens=news)
    assert outs == ref.generate(prompts, max_new_tokens=news)
    free = ServeEngine(cfg, ServePolicy(max_len=4 * t, max_slots=2),
                       params=tight.params, spec=h100_spec(smem_bytes=LEAF),
                       device="cpu")
    assert outs == free.generate(prompts, max_new_tokens=news)
    assert [len(o) for o in outs] == news
    assert tight.metrics["evictions"] >= 1
    assert tight.metrics["evictions"] == ref.metrics["evictions"]
    assert tight.metrics["pages_allocated"] == \
        tight.metrics["pages_released"]


def test_requests_carry_no_state_bytes():
    """The latent cache is all token-proportional: a request's fixed state
    is 0 B, as the reference's memory model says, and the per-token bytes
    are the latent row of every layer."""
    from repro.serve import kvcache as RK
    from repro_torch.serve.kvcache import kv_token_bytes

    for cfg, rcfg in ((get_model_config(ARCH), ref_config(ARCH)),
                      (get_model_config(ARCH).reduced(),
                       ref_config(ARCH).reduced())):
        assert request_state_bytes(cfg, 0, 2) == \
            RK.request_state_bytes(rcfg, 0, 2) == 0
        assert kv_token_bytes(cfg, 2) == RK.kv_token_bytes(rcfg, 2)
    full = get_model_config(ARCH)
    assert kv_token_bytes(full, 2) == (576 * 2 * 60, 60, 0)
