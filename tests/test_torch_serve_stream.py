"""``ServeEngine.generate(on_token=)`` against the JAX package's engines.

Each engine streams ``on_token(index_in_call, token)`` as tokens are
sampled, and ``on_token(i, None)`` when a recompute preemption throws a
request's tokens away (they re-emit).  On a tight-pool trace that preempts
(the paged engine) and on a budget that evicts a cohort (the cohort
engine), the port's calls equal the synchronous JAX engine's, and replaying
them rebuilds the lists ``generate`` returns.
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
from repro_torch.serve.kvcache import kv_token_bytes
from test_torch_serve_moe import _synchronous

ARCH = "llama3.2-1b"
LEAF = 16 << 10


def _pair(batching, **pol):
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    ref = RefEngine(ref_config(ARCH).reduced(),
                    Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model")),
                    policy=RefPolicy(batching=batching, **pol),
                    spec=ref_spec)
    if batching == "paged":
        ref = _synchronous(ref)
    cfg = get_model_config(ARCH).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(batching=batching, **pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=LEAF, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    return cfg, ref, mine


def _replay(calls, n):
    """The token lists a stream of ``on_token`` calls leaves behind."""
    outs = [[] for _ in range(n)]
    for i, tok in calls:
        if tok is None:
            outs[i] = []
        else:
            outs[i].append(tok)
    return outs


@pytest.mark.parametrize("batching", ["paged", "cohort"])
def test_on_token_stream_equals_jax_under_preemption(batching):
    cfg = get_model_config(ARCH).reduced()
    t = ServeEngine(cfg, ServePolicy(max_len=128),
                    spec=h100_spec(smem_bytes=LEAF),
                    device="cpu").page.page_tokens
    if batching == "paged":
        # Three usable pages for two growing slots: the older slot
        # preempts the younger, which requeues and re-streams.
        page_bytes = t * kv_token_bytes(cfg, 4)[0]
        pol = dict(max_len=4 * t, max_slots=2,
                   kv_budget_bytes=3 * page_bytes)
        news = [3 * t - 8, 2 * t - 8]
    else:
        # A 64-token budget with one slot a cohort: the younger cohort is
        # evicted and recomputed.
        pol = dict(max_len=64, max_slots=1,
                   kv_budget_bytes=kv_token_bytes(cfg, 4)[0] * 64)
        news = [30, 30]
    cfg, ref, mine = _pair(batching, **pol)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 8, dtype=np.int32) for _ in range(2)]
    calls, ref_calls = [], []
    outs = mine.generate(prompts, max_new_tokens=news,
                         on_token=lambda i, tok: calls.append((i, tok)))
    outs_ref = ref.generate(prompts, max_new_tokens=news,
                            on_token=lambda i, tok: ref_calls.append(
                                (i, None if tok is None else int(tok))))
    assert mine.metrics["evictions"] >= 1
    assert any(tok is None for _, tok in calls)     # a reset streamed
    assert calls == ref_calls
    assert outs == outs_ref
    assert _replay(calls, len(prompts)) == outs
    assert all(isinstance(tok, int) for _, tok in calls if tok is not None)


def test_on_token_streams_in_order_and_resets_per_call():
    """Indices are positions in the call, the callback is dropped when the
    call returns, and the second call -- every request a prefix hit --
    streams the first call's tokens."""
    cfg = get_model_config(ARCH).reduced()
    spec = h100_spec(smem_bytes=LEAF)
    eng = ServeEngine(cfg, ServePolicy(max_len=64, max_slots=2,
                                       prefix_cache="radix"),
                      spec=spec, device="cpu")
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 40, dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, 6 + i,
                                                    dtype=np.int32)])
               for i in range(3)]
    runs = []
    for _ in range(2):
        calls = []
        outs = eng.generate(prompts, max_new_tokens=[3, 5, 2],
                            on_token=lambda i, tok: calls.append((i, tok)))
        assert _replay(calls, 3) == outs
        assert [sum(1 for j, _ in calls if j == i) for i in range(3)] == \
            [3, 5, 2]
        assert eng._stream_cb is None and eng._stream_ix == {}
        runs.append(outs)
    assert runs[0] == runs[1]
    assert eng.metrics["prefix_hits"] >= 3
