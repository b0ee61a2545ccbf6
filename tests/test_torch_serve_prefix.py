"""The port's radix prefix cache in the paged engine against the JAX
package's, for the five prefix families.

For each family of ``PREFIX_FAMILIES`` at ``.reduced()``, two prompts share
a prefix that ends mid-page (the CoW path on attention families) or on a
page boundary.  Served through one slot with ``prefix_cache="radix"``, the
second request hits the first one's published pages: the port's greedy
tokens equal its cold run's and the synchronous JAX warm engine's, and the
prefix metrics equal JAX's (``tests/test_serve_prefix.py``'s case, with
the page read from an engine planned at the same ``max_len``).  Neither
prompt ends on a page boundary, where the JAX paged engine loses the first
decode token's K/V (ROADMAP Queue 3).
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
from repro_torch.serve import PREFIX_FAMILIES, ServeEngine, ServePolicy
from repro_torch.serve.pages import slot_rows
from test_torch_serve_moe import _synchronous

#: One arch per prefix family.
ARCHS = {"dense": "llama3.2-1b", "moe": "mixtral-8x7b",
         "hybrid_ssm": "zamba2-1.2b", "xlstm": "xlstm-1.3b",
         "mla_moe": "deepseek-v2-236b"}
#: Families whose hits restore a state snapshot and round down to pages.
STATE_ARCHS = {"zamba2-1.2b", "xlstm-1.3b"}
#: The reference test's tiny leaf (small pages), the same on both sides.
LEAF = 16 << 10
MAX_LEN = 256
NEW = 4
#: The metrics the port must report as the JAX engine does.
PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
               "pages_saved", "cow_copies", "prefill_tokens",
               "prefill_chunks", "prefix_nodes_inserted")


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _engines(arch, **pol):
    """The synchronous JAX warm engine, and the port's warm and cold
    engines on its parameters, leaf and policy (one slot: the second
    request is admitted after the first published its prefix)."""
    pol = dict(dict(max_new_tokens=NEW, max_len=MAX_LEN, max_slots=1,
                    batching="paged"), **pol)
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    ref = _synchronous(RefEngine(
        ref_config(arch).reduced(), _host_mesh(),
        policy=RefPolicy(prefix_cache="radix", **pol), spec=ref_spec))
    cfg = get_model_config(arch).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                               "cpu")
    spec = h100_spec(smem_bytes=LEAF, hbm_bytes=ref_spec.hbm_bytes)
    warm, cold = (ServeEngine(cfg, ServePolicy(prefix_cache=p, **pol),
                              params=params, spec=spec, device="cpu")
                  for p in ("radix", "off"))
    return cfg, ref, warm, cold


def _shared_prefix_prompts(cfg, t, geometry, rng):
    """Two prompts sharing ``n`` tokens: 2.5 pages (mid-page) or 2 pages
    (page boundary); tails long enough that the first request's divergent
    page completes, differing at their first token."""
    n = 2 * t + (t // 2 if geometry == "mid_page" else 0)
    shared = rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
    tails = [rng.integers(0, cfg.vocab_size, t // 2 + 2, dtype=np.int32)
             for _ in range(2)]
    tails[1][0] = (tails[0][0] + 1) % cfg.vocab_size
    return n, [np.concatenate([shared, tail]) for tail in tails]


def test_every_prefix_family_is_covered():
    assert set(ARCHS) == set(PREFIX_FAMILIES)


@pytest.mark.parametrize("geometry", ["mid_page", "page_boundary"])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_prefix_hit_tokens_and_metrics_equal_cold_and_jax(family, geometry):
    arch = ARCHS[family]
    cfg, ref, warm, cold = _engines(arch)
    t = warm.page.page_tokens
    assert ref.page.page_tokens == t
    n, prompts = _shared_prefix_prompts(cfg, t, geometry,
                                        np.random.default_rng(0xA11CE))
    assert all(len(p) % t for p in prompts)     # off the JAX fault
    restored = {}
    apply = warm._apply_prefix_hit

    def recording(cache, slot, hit):
        cache = apply(cache, slot, hit)
        restored.update({g: {k: slot_rows(buf, slot).float().clone()
                             for k, buf in cache["state"][g].items()}
                         for g in hit.state or {}})
        return cache

    warm._apply_prefix_hit = recording
    outs_cold = cold.generate(prompts)
    outs = warm.generate(prompts)
    outs_ref = ref.generate(prompts)
    assert outs == outs_cold, f"{arch}/{geometry}: a hit changed tokens"
    assert outs == outs_ref
    for key in PREFIX_KEYS:
        assert warm.metrics[key] == ref.metrics[key], key
    # Attention families reuse the prefix exactly (a CoW inside the
    # divergent page); recurrent-state families round down to the page.
    expect = (n // t) * t if arch in STATE_ARCHS else n
    m = warm.metrics
    assert (m["prefix_hits"], m["prefix_hit_tokens"]) == (1, expect)
    assert m["pages_saved"] == expect // t > 0
    mid = geometry == "mid_page" and arch not in STATE_ARCHS
    assert m["cow_copies"] == (1 if mid else 0)
    plen = len(prompts[0])
    assert m["prefill_tokens"] == plen + (plen - expect)
    assert m["prefix_budget_bytes"] == ref.metrics["prefix_budget_bytes"]
    assert m["prefix_resident_bytes"] == ref.metrics["prefix_resident_bytes"]
    stats, ref_stats = warm.stats(), ref.stats()
    for key in ("prefix_nodes", "prefix_pages", "prefix_resident_bytes",
                "used_pages"):
        assert stats[key] == ref_stats[key], key
    if arch in STATE_ARCHS:
        # The rows the restore wrote are the JAX engine's snapshot at the
        # hit boundary.
        at_hit = ref.export_pages(prompts[1])["snaps"][expect]
        assert set(restored) == set(at_hit)
        for g, rows in at_hit.items():
            for k, v in rows.items():
                np.testing.assert_allclose(
                    restored[g][k].numpy(), np.asarray(v, np.float32),
                    rtol=1e-4, atol=1e-4, err_msg=f"restore {g}.{k}")
        # The slot's recurrent state after the hit run (restored from the
        # snapshot, then the suffix and decode) is the JAX engine's:
        # tokens alone can miss a lost restore at this size.
        state = warm._paged_session.cache["state"]
        ref_state = ref._paged_session.cache["state"]
        for g, bufs in state.items():
            for k, buf in bufs.items():
                np.testing.assert_allclose(
                    buf.float().numpy(),
                    np.asarray(ref_state[g][k], np.float32),
                    rtol=1e-4, atol=1e-4, err_msg=f"{g}.{k}")
