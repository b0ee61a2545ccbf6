"""The port's hybrid_ssm (Zamba2) model steps and paged cache against the
JAX package's, at ``zamba2-1.2b.reduced()`` (4 Mamba2 layers, the shared
attention block before every 2, so 2 applications), with the JAX
parameters carried over by ``params_from_numpy``.

``prefill_chunk`` and ``decode_step_paged`` give the same logits, and leave
the same page pool and per-slot Mamba state (conv and SSM) behind, chunk
after chunk and slot by slot.  Tolerance: float32 1e-4 on logits, pool and
state (two frameworks' float32 products differ in summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_config
from repro.models.model import build_model as ref_build
from repro.serve.pages import init_paged_cache as ref_init_cache
from repro_torch.configs import get_model_config
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.kvcache import request_state_bytes
from repro_torch.serve.pages import init_paged_cache, reset_slot

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "zamba2-1.2b"


def _setup(seed=0):
    """Both packages' configs and models, and the JAX parameters with the
    mixers' constant-initialised leaves (dt_bias, A_log, D, conv bias)
    redrawn, so that the parity checks see them."""
    rcfg = ref_config(ARCH).reduced()
    cfg = get_model_config(ARCH).reduced()
    params = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    mamba = dict(params["mamba_layers"])
    for k in ("dt_bias", "A_log", "D", "conv_b"):
        mamba[k] = jnp.asarray(
            (rng.standard_normal(mamba[k].shape) * 0.5).astype(np.float32))
    params = dict(params, mamba_layers=mamba)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return rcfg, cfg, params, tparams


def _caches(rcfg, cfg, n_slots, p_total, t, n_logical):
    jcache = ref_init_cache(rcfg, ref_build(rcfg, remat="none"), n_slots,
                            p_total, t, n_logical, jnp.float32)
    tcache = init_paged_cache(cfg, n_slots, p_total, t, n_logical,
                              torch.float32, "cpu")
    return jcache, tcache


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _check_cache(jcache, tcache):
    """Pool and state leaves agree (same paths, shapes and values)."""
    for part in ("pool", "state"):
        jl, tl = _leaves(jcache[part]), _leaves(tcache[part])
        assert sorted(jl) == sorted(tl), part
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       err_msg=f"{part}.{k}", **TOL)


def test_param_tree_matches_the_reference():
    """``param_specs`` follows the reference's hybrid tree (mamba_layers
    stacked over all layers, one unstacked shared block), so
    ``params_from_numpy`` carries a zamba2 tree over leaf for leaf."""
    rcfg, cfg, params, tparams = _setup()
    ref = {k: tuple(v.shape) for k, v in _leaves(
        jax.tree.map(np.asarray, params)).items()}
    mine = {k: tuple(v.shape) for k, v in _leaves(tparams).items()}
    assert mine == ref
    assert mine["mamba_layers.wx"] == (cfg.n_layers, cfg.d_model,
                                       2 * cfg.d_model)
    assert mine["shared_attn.attn.wq"] == (cfg.d_model,
                                           cfg.n_heads * cfg.head_dim)
    seeded = Model(cfg).init(seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(seeded).items()} == mine


def test_paged_cache_layout_matches_the_reference():
    """One pool layer per shared-block application; conv state in the
    compute dtype, SSM state float32, the slot on axis 1."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    jcache = ref_init_cache(rcfg, ref_build(rcfg, remat="none"), 3, 9, 8, 4,
                            jnp.bfloat16)
    tcache = init_paged_cache(cfg, 3, 9, 8, 4, torch.bfloat16, "cpu")
    for part in ("pool", "state"):
        jl, tl = _leaves(jcache[part]), _leaves(tcache[part])
        assert {k: tuple(v.shape) for k, v in tl.items()} == \
            {k: tuple(v.shape) for k, v in jl.items()}
        for k in jl:
            assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype), k
    assert tcache["pool"]["k"].shape[0] == 2              # applications
    assert tcache["state"]["mamba"]["ssm"].dtype == torch.float32
    assert tcache["state"]["mamba"]["conv"].dtype == torch.bfloat16


def test_reset_slot_zeroes_only_that_slot():
    cfg = get_model_config(ARCH).reduced()
    cache = init_paged_cache(cfg, 3, 5, 8, 2, torch.float32, "cpu")
    for buf in _leaves(cache["state"]).values():
        buf.fill_(1.0)
    cache["pool"]["k"].fill_(2.0)
    out = reset_slot(cfg, cache, 1)
    for buf in _leaves(out["state"]).values():
        assert not buf[:, 1].any()
        assert (buf[:, 0] == 1).all() and (buf[:, 2] == 1).all()
    assert (out["pool"]["k"] == 2).all()


def test_request_state_bytes_is_the_slot_state():
    """The per-request state bytes are the bytes of one slot's rows of the
    cache's state buffers."""
    cfg = get_model_config(ARCH).reduced()
    cache = init_paged_cache(cfg, 2, 3, 8, 2, torch.bfloat16, "cpu")
    per_slot = sum(b[:, 0].numel() * b.element_size()
                   for b in _leaves(cache["state"]).values())
    assert request_state_bytes(cfg, dtype_bytes=2) == per_slot


def test_prefill_chunks_then_decode_step_match():
    """Slot 0 prefills 13 tokens in two chunks (8, then 5), slot 2 one
    chunk of 6; then one decode step over all three slots (slot 1 empty):
    logits after each call, and pool and state contents, agree."""
    rcfg, cfg, params, tparams = _setup(seed=1)
    t, p_total, n_logical = 8, 10, 3
    ref_model, model = ref_build(rcfg, remat="none"), Model(cfg)
    jcache, tcache = _caches(rcfg, cfg, 3, p_total, t, n_logical)
    table = np.array([[2, 5, 7], [0, 0, 0], [1, 3, 4]], np.int32)
    jcache["table"], tcache["table"] = jnp.asarray(table), \
        torch.from_numpy(table)
    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, cfg.vocab_size, 13).astype(np.int32),
               2: rng.integers(0, cfg.vocab_size, 6).astype(np.int32)}
    last = {}
    for slot, start, stop in ((0, 0, 8), (2, 0, 6), (0, 8, 13)):
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
        _check_cache(jcache, tcache)
        last[slot] = int(np.argmax(lt.numpy()))
    assert not tcache["state"]["mamba"]["ssm"][:, 1].any()   # slot 1 empty

    pos = np.array([13, 0, 6], np.int32)
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
    _check_cache(jcache, tcache)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_prefill_equals_one_chunk(dtype):
    """The state carried from chunk to chunk makes a prompt's last logits
    and its slot's state the same whether it arrives in pieces of 8, 8
    and 1 tokens (the last through ``ssd_step``) or as one chunk."""
    cfg = get_model_config(ARCH).reduced()
    model = Model(cfg)
    params = model.init(seed=2, device="cpu", dtype=dtype)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, 17).astype(np.int64))[None]
    out = {}
    for name, cuts in (("pieces", (0, 8, 16, 17)), ("whole", (0, 17))):
        cache = init_paged_cache(cfg, 1, 4, 8, 3, dtype, "cpu")
        cache["table"] = torch.tensor([[1, 2, 3]], dtype=torch.int32)
        with torch.no_grad():
            for lo, hi in zip(cuts, cuts[1:]):
                logits, cache = model.prefill_chunk(
                    params, cache, {"tokens": prompt[:, lo:hi], "pos0": lo,
                                    "slot": 0}, dtype=dtype)
        out[name] = (logits.float(), cache["state"]["mamba"]["ssm"].clone(),
                     cache["pool"]["k"].float().clone())
    tol = TOL if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    for a, b in zip(out["pieces"], out["whole"]):
        torch.testing.assert_close(a, b, **tol)
