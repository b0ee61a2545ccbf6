"""The port's paged MLA (``repro_torch.models.mla``) against the JAX
package's, at ``deepseek-v2-236b.reduced()`` (4 query heads over the one
latent "KV head", latent row 16 + 8 = 24 wide, q_lora 16).

``_mla_latent_row`` (the absorbed query, pre-scaled for the kernel, and
the latent row), ``paged_mla_attention_block`` (decode rows mid-page, at a
page boundary, empty, and one past the table, whose write lands on the
null page) and ``paged_mla_prefill_block`` (a chunk across three pages)
on the same pool, table and positions as the JAX functions, which run the
Pallas kernel in interpret mode.  Outputs and the written pool rows must
agree.

Tolerance: float32 1e-4 (two frameworks' float32 products differ in
summation order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_config
from repro.models import mla as RMLA
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_model_config
from repro_torch.models import mla as MLA
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-v2-236b"


def _setup(seed=0):
    rcfg = ref_config(ARCH).reduced()
    cfg = get_model_config(ARCH).reduced()
    params = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return rcfg, cfg, params, tparams


def _attn(params, tparams, group, layer):
    """Layer ``layer``'s MLA attention parameters of stack ``group``, as
    the JAX and the port's dicts."""
    ap = jax.tree.map(lambda a: a[layer], params[group]["attn"])
    tap = {k: v[layer] for k, v in tparams[group]["attn"].items()}
    return ap, tap


def _pool(cfg, p_total, t, seed):
    m = cfg.mla
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (cfg.n_layers, p_total, t, 1, m.kv_lora_rank + m.rope_head_dim)
    ).astype(np.float32)


def test_param_specs_follow_the_reference():
    """Same paths, shapes and axes as the JAX package's MLA specs, with and
    without the query's low-rank projection, and the model's tree: one
    dense layer (MLA + SwiGLU at ``dense_d_ff``) before the MoE layers."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    for q_lora in (cfg.mla.q_lora_rank, 0):
        r = dataclasses.replace(rcfg, mla=dataclasses.replace(
            rcfg.mla, q_lora_rank=q_lora))
        c = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=q_lora))
        ref = RMLA.mla_param_specs(r, 3)
        mine = MLA.mla_param_specs(c, 3)
        assert sorted(ref) == sorted(mine)
        for k in ref:
            assert (tuple(ref[k].shape), tuple(ref[k].axes), ref[k].init,
                    ref[k].scale) == (tuple(mine[k].shape),
                                      tuple(mine[k].axes), mine[k].init,
                                      mine[k].scale), k
    specs = Model(cfg).param_specs()
    assert specs["dense_layers"]["ffn"]["wi"].shape == \
        (1, cfg.d_model, cfg.moe.dense_d_ff)
    assert "moe" in specs["layers"] and "wkv_a" in specs["layers"]["attn"]
    # The whole tree, at the published widths too: the same paths, shapes
    # and axes as the JAX model's (what ``params_from_numpy`` and seeded
    # init walk).
    for r, c in ((rcfg, cfg), (ref_config(ARCH), get_model_config(ARCH))):
        ref_tree = _flat(ref_build(r, remat="none").param_specs())
        assert ref_tree == _flat(Model(c).param_specs())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: (tuple(tree.shape), tuple(tree.axes))}


def test_latent_row_matches():
    """The absorbed query (pre-scaled by sqrt(R + dr) / sqrt(nope + rope))
    and the latent row, at per-row positions."""
    rcfg, cfg, params, tparams = _setup()
    ap, tap = _attn(params, tparams, "layers", 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13],
                    [40, 41, 42, 43, 44]], np.int32)
    qj, lj = RMLA._mla_latent_row(ap, jnp.asarray(x), jnp.asarray(pos), rcfg)
    qt, lt = MLA._mla_latent_row(tap, torch.from_numpy(x),
                                 torch.from_numpy(pos), cfg)
    m = cfg.mla
    assert qt.shape == (3, 5, cfg.n_heads, m.kv_lora_rank + m.rope_head_dim)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("group,layer", [("dense_layers", 0), ("layers", 1)])
def test_paged_mla_attention_block_matches(group, layer):
    """Decode rows mid-page, at a page boundary, empty (null table row) and
    one past its table: outputs and the whole pool agree; the past-table
    write landed on the null page and the slot's last page is untouched."""
    rcfg, cfg, params, tparams = _setup()
    ap, tap = _attn(params, tparams, group, 0)
    t, p_total, n_logical = 8, 9, 3
    lat = _pool(cfg, p_total, t, 2)
    table = np.array([[3, 5, 0], [1, 2, 4], [0, 0, 0], [6, 7, 8]], np.int32)
    pos = np.array([10, 16, 0, n_logical * t + 3], np.int32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    out_j, lat_j = RMLA.paged_mla_attention_block(
        ap, jnp.asarray(x), jnp.asarray(pos), rcfg, jnp.asarray(lat), layer,
        jnp.asarray(table))
    tlat = torch.from_numpy(lat.copy())
    out_t = MLA.paged_mla_attention_block(
        tap, torch.from_numpy(x), torch.from_numpy(pos), cfg, tlat, layer,
        torch.from_numpy(table))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(lat_j), **TOL)
    assert not np.allclose(tlat[layer, 0, 3].numpy(), lat[layer, 0, 3])
    np.testing.assert_array_equal(tlat[layer, 8].numpy(), lat[layer, 8])


def test_paged_mla_prefill_block_matches():
    """A chunk of 16 tokens at positions 5..20 across three pages of one
    slot's table: output and the written latent rows agree."""
    rcfg, cfg, params, tparams = _setup(seed=1)
    ap, tap = _attn(params, tparams, "layers", 0)
    t, p_total = 8, 9
    lat = _pool(cfg, p_total, t, 4)
    table_row = np.array([4, 2, 7, 1], np.int32)
    positions = np.arange(5, 21, dtype=np.int32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    layer = 1
    out_j, lat_j = RMLA.paged_mla_prefill_block(
        ap, jnp.asarray(x), jnp.asarray(positions), rcfg, jnp.asarray(lat),
        layer, jnp.asarray(table_row))
    tlat = torch.from_numpy(lat.copy())
    out_t = MLA.paged_mla_prefill_block(
        tap, torch.from_numpy(x), torch.from_numpy(positions), cfg, tlat,
        layer, torch.from_numpy(table_row))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(lat_j), **TOL)
    # Positions 5..20 are pages 4 (offsets 5-7), 2 (all) and 7 (0-4);
    # page 1 and the rest of pages 4 and 7 are untouched.
    for pos in positions:
        page, off = table_row[pos // t], pos % t
        assert not np.allclose(tlat[layer, page, off].numpy(),
                               lat[layer, page, off])
    np.testing.assert_array_equal(tlat[layer, 1].numpy(), lat[layer, 1])
    np.testing.assert_array_equal(tlat[layer, 4, :5].numpy(),
                                  lat[layer, 4, :5])
    np.testing.assert_array_equal(tlat[layer, 7, 5:].numpy(),
                                  lat[layer, 7, 5:])
