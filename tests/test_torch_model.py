"""The port's paged attention blocks and paged model steps against the JAX
package on the same pool and table, with the JAX parameters carried over by
``params_from_numpy``.  Both the outputs (logits) and the pool contents
must agree -- including a write past the table, which lands on page 0.

Tolerance: float32 1e-4 on outputs and pool contents (two frameworks'
float32 matmuls differ in summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_config
from repro.models import layers as RL
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_model_config
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama3.2-1b", "qwen2-0.5b"]      # qwen2: QKV bias


def _setup(arch, seed=0):
    rcfg = ref_config(arch).reduced()
    cfg = get_model_config(arch).reduced()
    params = ref_build(rcfg, remat="none").init(jax.random.PRNGKey(seed))
    if rcfg.qkv_bias:   # the init zeroes biases: give them values to check
        rng = np.random.default_rng(seed)
        attn = dict(params["layers"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(
                rng.standard_normal(attn[b].shape).astype(np.float32))
        params = dict(params, layers=dict(params["layers"], attn=attn))
    numpy_tree = jax.tree.map(np.asarray, params)
    return rcfg, cfg, params, params_from_numpy(numpy_tree, cfg, "cpu")


def _pool(cfg, p_total, t, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, p_total, t, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _check_pools(jk, jv, tk, tv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_attention_block_matches(arch):
    rcfg, cfg, params, tparams = _setup(arch)
    t, p_total, n_logical = 8, 9, 3
    kp, vp = _pool(cfg, p_total, t, 1)
    table = np.array([[3, 5, 0], [1, 2, 4], [0, 0, 0], [6, 7, 8]], np.int32)
    # slot 0 mid-page; slot 1 at a page boundary; slot 2 empty (null row);
    # slot 3 one past its table: its write must land on null page 0.
    pos = np.array([10, 16, 0, n_logical * t + 3], np.int32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    layer = 1
    ap = jax.tree.map(lambda a: a[layer], params["layers"]["attn"])
    out_j, jk, jv = RL.paged_attention_block(
        ap, jnp.asarray(x), jnp.asarray(pos), rcfg, jnp.asarray(kp),
        jnp.asarray(vp), layer, jnp.asarray(table))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tap = {k: v[layer] for k, v in tparams["layers"]["attn"].items()}
    out_t = L.paged_attention_block(
        tap, torch.from_numpy(x), torch.from_numpy(pos), cfg, tk, tv, layer,
        torch.from_numpy(table))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _check_pools(jk, jv, tk, tv)
    # The past-the-table write went to page 0 (offset 3), and the slot's
    # last live page is untouched.
    assert not np.allclose(tk[layer, 0, 3].numpy(), kp[layer, 0, 3])
    np.testing.assert_array_equal(tk[layer, 8].numpy(), kp[layer, 8])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_block_matches(arch):
    rcfg, cfg, params, tparams = _setup(arch)
    t, p_total = 8, 9
    kp, vp = _pool(cfg, p_total, t, 3)
    table_row = np.array([4, 2, 7, 1], np.int32)
    positions = np.arange(5, 5 + 11, dtype=np.int32)   # spans 3 pages
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 11, cfg.d_model)).astype(np.float32)
    layer = 0
    ap = _layer0(params["layers"]["attn"])
    out_j, jk, jv = RL.paged_prefill_block(
        ap, jnp.asarray(x), jnp.asarray(positions), rcfg, jnp.asarray(kp),
        jnp.asarray(vp), layer, jnp.asarray(table_row))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tap = {k: v[layer] for k, v in tparams["layers"]["attn"].items()}
    out_t = L.paged_prefill_block(
        tap, torch.from_numpy(x), torch.from_numpy(positions), cfg, tk, tv,
        layer, torch.from_numpy(table_row))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _check_pools(jk, jv, tk, tv)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_then_decode_step_match(arch):
    """A chunk written into an empty pool, then a decode step over three
    slots (the chunked one, an empty one, one past its table), through the
    whole model: logits and pools agree after each."""
    rcfg, cfg, params, tparams = _setup(arch, seed=1)
    t, p_total, n_logical = 8, 10, 3
    ref_model, model = ref_build(rcfg, remat="none"), Model(cfg)
    shape = (cfg.n_layers, p_total, t, cfg.n_kv_heads, cfg.head_dim)
    table = np.array([[2, 5, 7], [0, 0, 0], [1, 3, 4]], np.int32)
    jcache = {"table": jnp.asarray(table), "pos": jnp.zeros(3, jnp.int32),
              "pool": {"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
              "state": {}}
    tcache = {"table": torch.from_numpy(table),
              "pos": torch.zeros(3, dtype=torch.int32),
              "pool": {"k": torch.zeros(shape), "v": torch.zeros(shape)},
              "state": {}}
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, 13).astype(np.int32)
    for start, stop in ((0, 8), (8, 13)):              # two chunks
        lj, jcache = ref_model.prefill_chunk(
            params, jcache, {"tokens": jnp.asarray(prompt[start:stop])[None],
                             "pos0": jnp.int32(start), "slot": jnp.int32(0)},
            dtype=jnp.float32)
        with torch.no_grad():
            lt, tcache = model.prefill_chunk(
                tparams, tcache,
                {"tokens": torch.from_numpy(prompt[start:stop])[None],
                 "pos0": start, "slot": 0}, dtype=torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _check_pools(jcache["pool"]["k"], jcache["pool"]["v"],
                 tcache["pool"]["k"], tcache["pool"]["v"])

    pos = np.array([13, 0, n_logical * t + 2], np.int32)
    toks = np.array([[int(np.argmax(lt.numpy()))], [0], [7]], np.int32)
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
    _check_pools(jcache["pool"]["k"], jcache["pool"]["v"],
                 tcache["pool"]["k"], tcache["pool"]["v"])
    assert np.abs(tcache["pool"]["k"][:, 0].numpy()).sum() > 0  # page 0 hit


def test_params_from_numpy_checks_the_layout():
    _, cfg, params, _ = _setup("llama3.2-1b")
    tree = jax.tree.map(np.asarray, params)
    tree["layers"] = dict(tree["layers"], ln1=tree["layers"]["ln1"][:1])
    with pytest.raises(ValueError, match="layers.ln1"):
        params_from_numpy(tree, cfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        params_from_numpy(tree, cfg, "cpu")


def test_other_families_are_not_served_yet():
    """Every registered family is served now (vlm the last), and an
    unknown family still raises."""
    import dataclasses

    for arch in ("qwen2-vl-7b", "deepseek-v2-236b", "whisper-large-v3"):
        Model(get_model_config(arch).reduced())               # served
    with pytest.raises(NotImplementedError, match="unknown"):
        Model(dataclasses.replace(get_model_config("llama3.2-1b").reduced(),
                                  family="unknown"))


_GROUPED = {"causal": dict(causal=True), "window": dict(causal=True, window=3),
            "kv_len": dict(causal=False, kv_len=np.array([5, 8]))}


@pytest.mark.parametrize("case", sorted(_GROUPED))
def test_grouped_attention_matches_repeat_kv_and_reference(case):
    """GQA against the unrepeated K/V equals ``repeat_kv`` +
    ``full_attention`` and the reference's ``grouped_attention``."""
    rng = np.random.default_rng(7)
    b, sq, sk, h, kv, d = 2, 3, 8, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    q_pos, k_pos = np.arange(sk - sq, sk), np.arange(sk)
    kw = dict(_GROUPED[case])
    kv_len = kw.pop("kv_len", None)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    tl = None if kv_len is None else torch.from_numpy(kv_len)
    mine = L.grouped_attention(*t, kv_len=tl, **kw).numpy()
    plain = L.full_attention(t[0], L.repeat_kv(t[1], h // kv),
                             L.repeat_kv(t[2], h // kv), t[3], t[4],
                             kv_len=tl, **kw).numpy()
    ref = np.asarray(RL.grouped_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw))
    np.testing.assert_allclose(mine, plain, **TOL)
    np.testing.assert_allclose(mine, ref, **TOL)


def test_attention_op_takes_grouped_attention_under_kv_seq_rules(
        monkeypatch):
    """A one-token query under rules that shard the KV sequence goes
    through ``grouped_attention``, with the same result as the plain
    dispatch (``constrain`` is the identity on plain tensors)."""
    from repro_torch.dist.sharding import (AbstractMesh, ShardingRules,
                                           use_mesh_rules)

    cfg = get_model_config("llama3.2-1b").reduced()
    rng = np.random.default_rng(8)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.from_numpy(rng.standard_normal((2, 1, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 8, kv, d)).astype(
        np.float32)) for _ in range(2))
    q_pos, k_pos = torch.tensor([7]), torch.arange(8)
    plain = L.attention_op(q, k, v, q_pos, k_pos, cfg)
    calls = []
    grouped = L.grouped_attention

    def spy(*a, **kw):
        calls.append(1)
        return grouped(*a, **kw)

    monkeypatch.setattr(L, "grouped_attention", spy)
    with use_mesh_rules(AbstractMesh((1, 4), ("data", "model")),
                        ShardingRules({}, {"kv_seq": "model"})):
        sharded = L.attention_op(q, k, v, q_pos, k_pos, cfg)
    assert calls == [1]
    np.testing.assert_allclose(sharded.numpy(), plain.numpy(), **TOL)
