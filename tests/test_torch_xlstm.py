"""The port's xLSTM cells, blocks and model steps against the JAX
package's.

``mlstm_chunkwise``, ``mlstm_step``, ``slstm_scan``, ``mlstm_block`` and
``slstm_block`` on the same inputs (made from a seed with numpy) give the
same outputs and states as the reference's; chained chunkwise calls equal
one long call (the state carried from call to call).
``xlstm-1.3b.reduced()``'s paged prefill chunks and decode step give the
same logits and leave the same per-slot state, leaf for leaf, as the JAX
model's.

Tolerance: float32 1e-4 (two frameworks' float32 products differ in
summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_config
from repro.models import xlstm as RX
from repro.models.model import build_model as ref_build
from repro.serve.pages import init_paged_cache as ref_init_cache
from repro_torch.configs import get_model_config
from repro_torch.models import xlstm as X
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.pages import init_paged_cache

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(mine, ref, what=""):
    if isinstance(mine, (tuple, list)):
        assert len(mine) == len(ref)
        for i, (a, b) in enumerate(zip(mine, ref)):
            _close(a, b, f"{what}[{i}]")
        return
    if isinstance(mine, dict):
        assert sorted(mine) == sorted(ref), what
        for k in ref:
            _close(mine[k], ref[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref),
                               err_msg=what, **TOL)


def _mlstm_inputs(seed, b=2, s=21, h=2, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _mlstm_state(seed, b=2, h=2, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.3,
            rng.standard_normal((b, h, d)).astype(np.float32) * 0.3,
            rng.standard_normal((b, h)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_the_reference(chunk, with_state):
    """Ragged lengths (21 tokens over chunks of 4 and 8 pad the last
    chunk), one chunk longer than the call, from zeros or a state."""
    args = _mlstm_inputs(0)
    state = _mlstm_state(1) if with_state else None
    hj, sj = RX.mlstm_chunkwise(*(jnp.asarray(a) for a in args), chunk,
                                None if state is None
                                else tuple(jnp.asarray(a) for a in state))
    ht, st = X.mlstm_chunkwise(*(_t(a) for a in args), chunk,
                               None if state is None
                               else tuple(_t(a) for a in state))
    _close(ht, hj, "h")
    _close(st, sj, "state")


def test_mlstm_step_matches_the_reference():
    q, k, v, i_pre, f_pre = (a[:, 0] for a in _mlstm_inputs(2))
    state = _mlstm_state(3)
    hj, sj = RX.mlstm_step(*(jnp.asarray(a) for a in (q, k, v, i_pre,
                                                      f_pre)),
                           tuple(jnp.asarray(a) for a in state))
    ht, st = X.mlstm_step(*(_t(a) for a in (q, k, v, i_pre, f_pre)),
                          tuple(_t(a) for a in state))
    _close(ht, hj, "h")
    _close(st, sj, "state")


def test_chained_chunkwise_calls_equal_one_call_and_the_step():
    """Three calls of 7 tokens, each from the last one's state, give the
    one 21-token call's output and final state; so does the one-token
    step applied 21 times."""
    q, k, v, i_pre, f_pre = (_t(a) for a in _mlstm_inputs(4))
    whole, fin = X.mlstm_chunkwise(q, k, v, i_pre, f_pre, 8)
    state, parts = None, []
    for lo in range(0, 21, 7):
        part, state = X.mlstm_chunkwise(q[:, lo:lo + 7], k[:, lo:lo + 7],
                                        v[:, lo:lo + 7], i_pre[:, lo:lo + 7],
                                        f_pre[:, lo:lo + 7], 8, state)
        parts.append(part)
    torch.testing.assert_close(torch.cat(parts, 1), whole, **TOL)
    for a, b in zip(state, fin):
        torch.testing.assert_close(a, b, **TOL)
    b_, h, d = q.shape[0], q.shape[2], q.shape[3]
    state = (torch.zeros(b_, h, d, d), torch.zeros(b_, h, d),
             torch.full((b_, h), X.NEG))
    steps = []
    for i in range(21):
        out, state = X.mlstm_step(q[:, i], k[:, i], v[:, i], i_pre[:, i],
                                  f_pre[:, i], state)
        steps.append(out)
    torch.testing.assert_close(torch.stack(steps, 1), whole, **TOL)


@pytest.mark.parametrize("s", [1, 9])
def test_slstm_scan_matches_the_reference(s):
    rng = np.random.default_rng(5)
    b, h, d = 2, 2, 8
    gx = rng.standard_normal((b, s, h, 4, d)).astype(np.float32)
    R = (rng.standard_normal((h, d, 4, d)) * 0.3).astype(np.float32)
    state = tuple((rng.standard_normal((b, h, d)) * 0.5).astype(np.float32)
                  for _ in range(4))
    hj, sj = RX.slstm_scan(jnp.asarray(gx), jnp.asarray(R),
                           tuple(jnp.asarray(a) for a in state))
    ht, st = X.slstm_scan(_t(gx), _t(R), tuple(_t(a) for a in state))
    _close(ht, hj, "h")
    _close(st, sj, "state")


def _block_params(specs, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(spec.shape)
                / np.sqrt(spec.shape[0] if spec.shape[0] > 4 else 4)
                ).astype(np.float32) + (1.0 if spec.init == "ones" else 0.0)
            for k, spec in specs.items()}


def _block_cache(kind, cfg, b, seed):
    """A random cache for one block (slot on axis 0)."""
    state = Model(cfg).init_state(b, torch.float32, "cpu")
    group = state["mlstm" if kind == "mlstm" else "slstm"]
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(tuple(v.shape[1:])) * 0.3).astype(
        np.float32) for k, v in group.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("s,cached", [(11, False), (11, True), (1, True)])
def test_blocks_match_the_reference(kind, s, cached):
    """Both blocks without a cache, with one over 11 tokens (chunkwise
    from the cache's state) and with one over a single token (the step);
    outputs and new caches agree."""
    cfg, rcfg = get_model_config(ARCH).reduced(), ref_config(ARCH).reduced()
    mine_specs = (X.mlstm_param_specs if kind == "mlstm"
                  else X.slstm_param_specs)(cfg)
    ref_specs = (RX.mlstm_param_specs if kind == "mlstm"
                 else RX.slstm_param_specs)(rcfg)
    assert {k: (v.shape, v.axes) for k, v in mine_specs.items()} == \
        {k: (v.shape, v.axes) for k, v in ref_specs.items()}
    params = _block_params(mine_specs, seed=s)
    rng = np.random.default_rng(s + 1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cache = _block_cache(kind, cfg, 2, seed=s + 2) if cached else None
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jc = None if cache is None else {k: jnp.asarray(v)
                                     for k, v in cache.items()}
    tc = None if cache is None else {k: _t(v) for k, v in cache.items()}
    if kind == "mlstm":
        yj, nj = RX.mlstm_block(jp, jnp.asarray(x), rcfg, jc, chunk=4)
        yt, nt = X.mlstm_block(tp, _t(x), cfg, tc, chunk=4)
    else:
        yj, nj = RX.slstm_block(jp, jnp.asarray(x), rcfg, jc)
        yt, nt = X.slstm_block(tp, _t(x), cfg, tc)
    _close(yt, yj, "out")
    assert (nt is None) == (nj is None)
    if nt is not None:
        _close(nt, nj, "cache")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_paged_cache_is_the_reference_state():
    """State only (no pool), the reference's leaves, shapes, dtypes and
    start values: zeros, the stabilisers ``m`` at ``NEG``."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    jcache = ref_init_cache(rcfg, ref_build(rcfg, remat="none"), 3, 2, 64,
                            1, jnp.bfloat16)
    tcache = init_paged_cache(cfg, 3, 2, 64, 1, torch.bfloat16, "cpu")
    assert tcache["pool"] == {} and jcache["pool"] == {}
    jl, tl = _leaves(jcache["state"]), _leaves(tcache["state"])
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype), k
        np.testing.assert_array_equal(tl[k].float().numpy(),
                                      np.asarray(jl[k], np.float32), k)
    assert (tl["mlstm.m"] == X.NEG).all() and (tl["slstm.m"] == X.NEG).all()


def test_prefill_chunks_then_decode_step_match():
    """Slot 0 prefills 21 tokens in two chunks (16, then 5), slot 2 one
    chunk of 6; then one decode step over all three slots (slot 1 empty):
    logits after each call and every state leaf agree with the JAX
    model's."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    params = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    ref_model, model = ref_build(rcfg, remat="none"), Model(cfg)
    jcache = ref_init_cache(rcfg, ref_model, 3, 2, 64, 1, jnp.float32)
    tcache = init_paged_cache(cfg, 3, 2, 64, 1, torch.float32, "cpu")

    def check_state():
        jl, tl = _leaves(jcache["state"]), _leaves(tcache["state"])
        assert sorted(jl) == sorted(tl)
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       err_msg=k, **TOL)

    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, cfg.vocab_size, 21).astype(np.int32),
               2: rng.integers(0, cfg.vocab_size, 6).astype(np.int32)}
    last = {}
    for slot, start, stop in ((0, 0, 16), (2, 0, 6), (0, 16, 21)):
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
        check_state()
        last[slot] = int(np.argmax(lt.numpy()))
    assert (tcache["state"]["mlstm"]["m"][:, 1] == X.NEG).all()  # untouched

    pos = np.array([21, 0, 6], np.int32)
    toks = np.array([[last[0]], [0], [last[2]]], np.int32)
    jcache["pos"], tcache["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    lj, jcache = ref_model.decode_step_paged(
        params, jcache, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32)
    with torch.no_grad():
        lt, tcache = model.decode_step_paged(
            tparams, tcache, {"tokens": torch.from_numpy(toks)},
            dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    check_state()
