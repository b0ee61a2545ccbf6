"""The port's paged ``ServeEngine`` on the xlstm family (token-free: the
per-slot mLSTM and sLSTM states are its whole cache) against the JAX
package's.

Greedy decode of ``xlstm-1.3b.reduced()`` is token-identical between the
JAX paged engine and the port on the CPU, with the same parameters, under
chunked and monolithic prefill: no page is ever allocated, and the
prompts are cut at the 64-token fallback page (70 tokens: two chunks, the
state carried across them).  Admission resets a slot's state to
``init_cache``'s values (the stabilisers at ``NEG``, not zero), and a slot
whose prompt streams in while another decodes keeps its state through the
ticks it rides: its tokens equal the same request's served alone.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServePolicy as RefPolicy
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.models.params import params_from_numpy
from repro_torch.models.xlstm import NEG
from repro_torch.serve import ServeEngine, ServePolicy
from repro_torch.serve.kvcache import DEFAULT_PAGE_TOKENS, request_state_bytes
from repro_torch.serve.pages import init_paged_cache, reset_slot
from test_torch_serve_moe import _synchronous

ARCH = "xlstm-1.3b"
LENS = (8, 70, 17)
NEWS = [6, 3, 2]
LEAF = 16 << 10


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_greedy_tokens_identical_to_jax_paged_engine(prefill):
    rcfg = ref_config(ARCH).reduced()
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    pol = dict(max_new_tokens=4, max_len=128, max_slots=2, batching="paged",
               prefill=prefill)
    ref = _synchronous(RefEngine(rcfg, _host_mesh(),
                                 policy=RefPolicy(**pol), spec=ref_spec))
    cfg = get_model_config(ARCH).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(**pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=LEAF, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in LENS]
    outs_ref = ref.generate(prompts, max_new_tokens=NEWS)
    outs = mine.generate(prompts, max_new_tokens=NEWS)
    assert outs == outs_ref
    assert [len(o) for o in outs] == NEWS
    assert mine.page.page_tokens == DEFAULT_PAGE_TOKENS
    assert mine.page.page_bytes == 0
    for key in ("page_tokens", "pages_total", "pages_per_slot",
                "prefill_chunks", "decode_steps", "backfills",
                "pages_allocated", "pages_released"):
        assert mine.metrics[key] == ref.metrics[key], key
    assert list(mine.metrics["interleave"]) == list(ref.metrics["interleave"])
    assert mine.metrics["pages_allocated"] == 0
    assert mine.metrics["prefill_chunks"] == \
        (4 if prefill == "chunked" else 3)


def test_reset_slot_writes_init_values_in_that_slot_only():
    cfg = get_model_config(ARCH).reduced()
    cache = init_paged_cache(cfg, 3, 2, DEFAULT_PAGE_TOKENS, 1,
                             torch.bfloat16, "cpu")
    fresh = _leaves(init_paged_cache(cfg, 1, 2, DEFAULT_PAGE_TOKENS, 1,
                                     torch.bfloat16, "cpu")["state"])
    assert cache["pool"] == {}
    for buf in _leaves(cache["state"]).values():
        buf.fill_(1.0)
    out = reset_slot(cfg, cache, 1)
    for name, buf in _leaves(out["state"]).items():
        assert torch.equal(buf[:, 1], fresh[name][:, 0]), name
        assert (buf[:, 0] == 1).all() and (buf[:, 2] == 1).all(), name
        want = NEG if name.endswith(".m") else 0.0
        assert (buf[:, 1] == want).all(), name


def test_frozen_slot_resumes_with_its_state():
    """Request 1's 3-chunk prompt streams in while request 0 decodes: its
    slot rides through those decode ticks, so its mLSTM and sLSTM state
    must not advance there.  Its tokens equal the same request's served
    alone."""
    cfg = get_model_config(ARCH).reduced()
    spec = h100_spec(smem_bytes=LEAF)
    alone = ServeEngine(cfg, ServePolicy(max_len=256, max_slots=1),
                        spec=spec, device="cpu")
    rng = np.random.default_rng(3)
    short = rng.integers(0, cfg.vocab_size, 5, dtype=np.int32)
    long = rng.integers(0, cfg.vocab_size, 2 * DEFAULT_PAGE_TOKENS + 9,
                        dtype=np.int32)
    want = alone.generate([long], max_new_tokens=[4])[0]
    both = ServeEngine(cfg, ServePolicy(max_len=256, max_slots=2),
                       params=alone.params, spec=spec, device="cpu")
    outs = both.generate([short, long], max_new_tokens=[8, 4])
    assert outs[1] == want
    trace = list(both.metrics["interleave"])
    chunks = [i for i, e in enumerate(trace) if e[0] == "chunk" and
              e[1] == 1]
    assert len(chunks) == 3
    assert any(trace[i][0] == "decode" and 1 not in trace[i][1]
               for i in range(chunks[0], chunks[-1]))


def test_requests_carry_their_state_bytes():
    """A request's fixed admission cost is its slot's rows of the state
    buffers."""
    cfg = get_model_config(ARCH).reduced()
    cache = init_paged_cache(cfg, 2, 2, DEFAULT_PAGE_TOKENS, 1,
                             torch.bfloat16, "cpu")
    per_slot = sum(b[:, 0].numel() * b.element_size()
                   for b in _leaves(cache["state"]).values())
    assert request_state_bytes(cfg, dtype_bytes=2) == per_slot
    engine = ServeEngine(cfg, ServePolicy(max_len=64),
                         spec=h100_spec(smem_bytes=LEAF), device="cpu")
    assert engine._make_request(np.arange(5), 3).state_bytes == \
        request_state_bytes(cfg, 0, 4) > 0
