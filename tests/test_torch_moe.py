"""The port's MoE FFN and the moe family's model steps against the JAX
package's.

``moe_ffn`` on the same inputs (made from a seed with numpy) gives the
same output and auxiliary loss as the reference, dropless
(``capacity_factor=None``), at the decode step's 1.25 and at a capacity
that drops slots, with and without shared experts; the parameter specs
have the reference's paths, shapes and axes.  ``mixtral-8x7b.reduced()``'s
paged prefill chunks (past its 32-token window) and decode step give the
same logits and leave the same pool as the JAX model's.  On a card,
``moe_ffn`` in bf16 agrees with float32 on the CPU.

Tolerance: float32 1e-4 (two frameworks' float32 products differ in
summation order only).
"""

import math

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax: there only the gpu case runs
    import jax
    import jax.numpy as jnp
    from repro.configs import get_model_config as ref_config
    from repro.models import moe as RM
    from repro.models.model import build_model as ref_build
    from repro.serve.pages import init_paged_cache as ref_init_cache
except ImportError:
    jax = None
from repro_torch.configs import get_model_config
from repro_torch.models import moe as M
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.pages import init_paged_cache

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mixtral-8x7b"


def _need_jax():
    if jax is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _ffn_case(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
              for k, spec in M.moe_param_specs(cfg).items()}
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return params, x


def _drops(cfg, params, x, cf) -> int:
    """Routed slots at or past the capacity (what the dispatch drops)."""
    mo = cfg.moe
    b, s, _ = x.shape
    cap = s if cf is None else max(1, math.ceil(s * mo.top_k * cf /
                                                mo.n_experts))
    logits = x @ params["router"]
    top = np.argsort(-logits, axis=-1)[..., :mo.top_k].reshape(b, -1)
    counts = np.stack([np.bincount(r, minlength=mo.n_experts) for r in top])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_param_specs_match_the_reference(arch):
    """Same paths, shapes, axes and init as the reference's, with and
    without shared experts, unstacked and stacked over layers."""
    _need_jax()
    cfg, rcfg = get_model_config(arch).reduced(), ref_config(arch).reduced()
    for layers in (0, 3):
        mine, ref = M.moe_param_specs(cfg, layers), \
            RM.moe_param_specs(rcfg, layers)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert (mine[k].shape, mine[k].axes, mine[k].init,
                    mine[k].scale) == (ref[k].shape, ref[k].axes,
                                       ref[k].init, ref[k].scale), k


def test_model_param_tree_matches_the_reference():
    _need_jax()
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    ref = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(0))
    flat_ref = {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    seeded = Model(cfg).init(seed=0, device="cpu")
    flat = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(seeded)}
    assert flat == flat_ref
    assert flat["['layers']['moe']['wi']"] == (
        cfg.n_layers, cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
@pytest.mark.parametrize("b,s,cf", [
    (2, 16, None),      # dropless: chunked prefill
    (2, 16, 1.25),      # the decode step's factor over a longer call
    (2, 16, 0.5),       # a capacity that drops slots
    (8, 1, 1.25),       # decode: one token a row, dropless by construction
])
def test_moe_ffn_matches_the_reference(arch, b, s, cf):
    _need_jax()
    cfg, rcfg = get_model_config(arch).reduced(), ref_config(arch).reduced()
    params, x = _ffn_case(cfg, b, s, seed=b + s)
    if cf == 0.5:
        assert _drops(cfg, params, x, cf) > 0     # the drop path runs
    if s == 1 or cf is None:
        assert _drops(cfg, params, x, cf) == 0
    yj, auxj = RM.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), rcfg.moe, cf)
    yt, auxt = M.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), cfg.moe, cf)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    assert yt.dtype == torch.float32 and auxt.shape == ()


def test_dropless_dispatch_is_chunk_invariant():
    """``capacity_factor=None`` gives every token the same output whether
    the row arrives whole or in pieces (what makes chunked prefill
    token-identical to monolithic)."""
    cfg = get_model_config(ARCH).reduced()
    params, x = _ffn_case(cfg, 1, 24, seed=3)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    whole = M.moe_ffn(p, xt, cfg.moe, None)[0]
    parts = torch.cat([M.moe_ffn(p, xt[:, lo:lo + 8], cfg.moe, None)[0]
                       for lo in range(0, 24, 8)], dim=1)
    torch.testing.assert_close(parts, whole, **TOL)


def test_prefill_chunks_past_the_window_then_decode_match():
    """Slot 0 prefills 40 tokens (past the 32-token window) in chunks of
    16, 16 and 8, slot 2 one chunk of 6; then one decode step over all
    three slots (slot 1 empty).  Logits after each call, and the pool,
    agree with the JAX model's."""
    _need_jax()
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    assert cfg.sliding_window == 32
    params = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    ref_model, model = ref_build(rcfg, remat="none"), Model(cfg)
    t, p_total, n_logical = 8, 12, 6
    jcache = ref_init_cache(rcfg, ref_model, 3, p_total, t, n_logical,
                            jnp.float32)
    tcache = init_paged_cache(cfg, 3, p_total, t, n_logical, torch.float32,
                              "cpu")
    table = np.array([[2, 5, 7, 9, 11, 10], [0] * 6, [1, 3, 0, 0, 0, 0]],
                     np.int32)
    jcache["table"], tcache["table"] = jnp.asarray(table), \
        torch.from_numpy(table)
    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, cfg.vocab_size, 40).astype(np.int32),
               2: rng.integers(0, cfg.vocab_size, 6).astype(np.int32)}

    def check_pool():
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache["pool"][name].numpy(),
                                       np.asarray(jcache["pool"][name]),
                                       **TOL)

    last = {}
    for slot, start, stop in ((0, 0, 16), (2, 0, 6), (0, 16, 32),
                              (0, 32, 40)):
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
    assert tcache["state"] == {}                 # the family has no state

    pos = np.array([40, 0, 6], np.int32)
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,cf", [(8, 1, 1.25), (1, 24, None)])
def test_cuda_moe_ffn_bf16_matches_cpu_float32(b, s, cf):
    """``moe_ffn`` in bf16 on the card (Mixtral's 8 experts, top 2, at a
    narrower width) against float32 on the CPU, on the decode and the
    prefill-chunk shapes.  Tokens whose second and third router logits
    lie within 0.25 (~20 bf16 rounding units of these logits) may route
    differently in bf16 and are left out; at least three quarters are
    held to 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dataclasses import replace

    cfg = get_model_config(ARCH)
    cfg = replace(cfg, d_model=512, moe=replace(cfg.moe, d_ff_expert=1024))
    params, x = _ffn_case(cfg, b, s, seed=7)
    params = {k: v / np.sqrt(v.shape[-2]) if v.ndim == 3 else v
              for k, v in params.items()}
    p32 = {k: torch.from_numpy(v) for k, v in params.items()}
    ref, _ = M.moe_ffn(p32, torch.from_numpy(x), cfg.moe, cf)
    pbf = {k: v.to("cuda", torch.bfloat16) for k, v in p32.items()}
    out, aux = M.moe_ffn(pbf, torch.from_numpy(x).to("cuda", torch.bfloat16),
                         cfg.moe, cf)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(aux)
    top3 = torch.from_numpy(x @ params["router"]).topk(3, dim=-1).values
    clear = (top3[..., 1] - top3[..., 2]) > 0.25
    assert clear.float().mean() >= 0.75
    err = (out.float().cpu() - ref).abs()[clear]
    assert bool((err <= 2e-2 * (1 + ref.abs()[clear])).all()), \
        float(err.max())
