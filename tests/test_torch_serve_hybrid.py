"""The port's paged ``ServeEngine`` on the hybrid_ssm family (Zamba2)
against the JAX package's, and under pool pressure.

Greedy decode of ``zamba2-1.2b.reduced()`` on a trace with backfill is
token-identical between the JAX paged engine and the port on the CPU,
with the same parameters and page geometry.  The prompts cut into 16-token
chunks with a one-token tail (33 and 17 tokens), so the mixers carry their
state across chunks and a tail chunk takes ``ssd_step``; the prefilling
slot rides through decode ticks, so its state must be frozen there.
Traces stay moderate: near-tied logits could flip a greedy token under
another summation order (``tests/test_serve_paged.py``).
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
from repro_torch.serve.kvcache import request_state_bytes

ARCH = "zamba2-1.2b"
LENS = (8, 33, 17)
NEWS = [6, 3, 2]
#: The same tiny leaf (and the same HBM) on both sides: 16-token pages.
LEAF = 16 << 10


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in LENS]


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_greedy_tokens_identical_to_jax_paged_engine(prefill):
    rcfg = ref_config(ARCH).reduced()
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    pol = dict(max_new_tokens=4, max_len=64, max_slots=2, batching="paged",
               prefill=prefill)
    ref = RefEngine(rcfg, _host_mesh(), policy=RefPolicy(**pol),
                    spec=ref_spec)
    cfg = get_model_config(ARCH).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(**pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=LEAF, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    prompts = _prompts(cfg)
    outs_ref = ref.generate(prompts, max_new_tokens=NEWS)
    outs = mine.generate(prompts, max_new_tokens=NEWS)
    assert outs == outs_ref
    assert [len(o) for o in outs] == NEWS
    for key in ("page_tokens", "pages_total", "pages_per_slot",
                "prefill_chunks", "decode_steps", "backfills",
                "pages_allocated", "pages_released"):
        assert mine.metrics[key] == ref.metrics[key], key
    assert list(mine.metrics["interleave"]) == list(ref.metrics["interleave"])
    assert mine.metrics["backfills"] >= 1
    assert mine.metrics["pages_allocated"] == mine.metrics["pages_released"]
    if prefill == "chunked":
        # A prefilling slot rode through a decode tick (its state frozen).
        trace = list(mine.metrics["interleave"])
        assert any(e[0] == "decode" and 1 not in e[1]
                   and any(c[0] == "chunk" and c[1] == 1
                           for c in trace[i + 1:])
                   for i, e in enumerate(trace))


@pytest.mark.parametrize("news,resumes", [
    ((3, 2), False),      # the reference test's trace: the stalled slot is
                          # evicted by the older one's growth
    ((1.25, 2), True),    # the older request ends within its pages: the
                          # stalled slot resumes on its frozen state
])
def test_stall_preserves_recurrent_state(news, resumes):
    """Under pool pressure a stalled slot rides through the decode batch,
    but its Mamba conv and SSM state must not advance on the discarded
    tick: the tight-pool run stays token-identical to an unconstrained
    one (the counterpart of ``tests/test_serve_paged.py``'s)."""
    cfg = get_model_config(ARCH).reduced()
    spec = h100_spec(smem_bytes=LEAF)
    probe = ServeEngine(cfg, ServePolicy(max_len=128), spec=spec,
                        device="cpu")
    t = probe.page.page_tokens
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
               for _ in range(2)]
    news = [int(f * t) - 8 for f in news]
    free = ServeEngine(cfg, ServePolicy(max_len=4 * t, max_slots=2),
                       params=probe.params, spec=spec, device="cpu")
    ref = free.generate(prompts, max_new_tokens=news)
    tight = ServeEngine(
        cfg, ServePolicy(max_len=4 * t, max_slots=2,
                         kv_budget_bytes=probe.page.page_bytes * 3),
        params=probe.params, spec=spec, device="cpu")
    outs = tight.generate(prompts, max_new_tokens=news)
    assert tight.metrics["stalls"] >= 1      # the pressure path ran
    assert free.metrics["stalls"] == 0
    assert (tight.metrics["evictions"] == 0) == resumes
    assert outs == ref
    assert tight.metrics["pages_allocated"] == \
        tight.metrics["pages_released"]


def test_requests_carry_their_state_bytes():
    cfg = get_model_config(ARCH).reduced()
    engine = ServeEngine(cfg, ServePolicy(max_len=64),
                         spec=h100_spec(smem_bytes=LEAF), device="cpu")
    req = engine._make_request(np.arange(5), 3)
    assert req.state_bytes == request_state_bytes(cfg, 0, 4) > 0
    dense = ServeEngine(get_model_config("llama3.2-1b").reduced(),
                        ServePolicy(max_len=64),
                        spec=h100_spec(smem_bytes=LEAF), device="cpu")
    assert dense._make_request(np.arange(5), 3).state_bytes == 0
