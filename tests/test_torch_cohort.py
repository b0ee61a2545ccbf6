"""The port's contiguous-cache path (the cohort engine's layers, model steps
and cache operations) against the JAX package's, on the CPU.

``apply_mrope`` with three distinct position streams; the cached
``attention_block`` -- one-token appends into a growable cache, decode
across a sliding-window ring's wrap, prefill storing the tail (rolled for
a ring) with ``S >= W`` and from slot 0 with ``S < W``, M-RoPE;
``blockwise_attention`` at explicit blocks (causal, windowed, non-causal
over padded keys) and ``attention_op``'s blockwise branch under a small
threshold; ``mla_attention`` in both forms; ``grow_cache``,
``take_slots`` and ``cache_capacity``; and ``Model.prefill`` then three
``decode_step``s, logits and every cache leaf, for all seven families.
Weights go JAX -> numpy -> ``params_from_numpy``; inputs are made from a
numpy seed.

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
from repro.models import layers as RL
from repro.models import mla as RMLA
from repro.models.model import build_model as ref_build
from repro.serve import kvcache as RKV
from repro_torch.configs import get_model_config
from repro_torch.core.autotile import plan_attention
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as KV

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILY_ARCHS = ["llama3.2-1b", "qwen2-vl-7b", "mixtral-8x7b",
                "deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b",
                "whisper-large-v3"]


def _setup(arch, seed=0):
    rcfg = ref_config(arch).reduced()
    cfg = get_model_config(arch).reduced()
    ref = ref_build(rcfg, remat="none")
    params = ref.init(jax.random.PRNGKey(seed))
    if rcfg.qkv_bias:   # the init zeroes biases: give them values to check
        rng = np.random.default_rng(seed)
        attn = dict(params["layers"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(
                rng.standard_normal(attn[b].shape).astype(np.float32))
        params = dict(params, layers=dict(params["layers"], attn=attn))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return rcfg, cfg, ref, params, tparams


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _check_cache(tcache, jcache):
    """Same leaves; counters equal, buffers within TOL."""
    ft, fj = _flat(tcache), _flat(jax.tree.map(np.asarray, jcache))
    assert set(ft) == set(fj), set(ft) ^ set(fj)
    for k, want in fj.items():
        got = np.asarray(ft[k])
        assert got.shape == want.shape, (k, got.shape, want.shape)
        if k.endswith(("len", "pos")):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _positions_3d(b, s, seed):
    """Three distinct streams: temporal steps every 6, rows and columns of
    a 3-wide grid."""
    i = np.arange(s)
    pos = np.stack([i // 6, (i // 3) % 5, i % 3 + 2 * (i // 9)])
    pos = np.broadcast_to(pos[:, None], (3, b, s)).copy()
    pos[:, 1:] += np.random.default_rng(seed).integers(0, 4)
    return pos.astype(np.int32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 128])
def test_apply_mrope_matches(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 11, 3, d)).astype(np.float32)
    pos = _positions_3d(2, 11, 1)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Equal streams make it RoPE at that stream.
    same = np.broadcast_to(np.arange(11)[None, None], (3, 2, 11)).copy()
    np.testing.assert_allclose(
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(same)).numpy(),
        L.apply_rope(torch.from_numpy(x), torch.arange(11), 1e6).numpy(),
        **TOL)
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                      sections=(1, 2, 3))


def _attn_cache(w, kv, hd, b, idx, seed):
    """A layer cache with ``idx`` filled (random) rows: JAX and port."""
    rng = np.random.default_rng(seed)
    k = np.zeros((b, w, kv, hd), np.float32)
    v = np.zeros((b, w, kv, hd), np.float32)
    k[:, :min(idx, w)] = rng.standard_normal((b, min(idx, w), kv, hd))
    v[:, :min(idx, w)] = rng.standard_normal((b, min(idx, w), kv, hd))
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "len": jnp.asarray(idx, jnp.int32)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "len": torch.tensor(idx, dtype=torch.int32)}
    return jc, tc


@pytest.mark.parametrize("arch,w,idx,s", [
    ("llama3.2-1b", 24, 9, 1),       # append into a growable cache
    ("llama3.2-1b", 24, 0, 13),      # prefill shorter than the buffer
    ("mixtral-8x7b", 32, 45, 1),     # decode across the ring's wrap
    ("mixtral-8x7b", 32, 31, 1),     # the last slot before the wrap
    ("mixtral-8x7b", 32, 0, 40),     # prefill past the ring: rolled tail
    ("mixtral-8x7b", 32, 0, 32),     # prefill of exactly one ring
    ("mixtral-8x7b", 20, 0, 12),     # a ring clamped under the window
    ("qwen2-vl-7b", 24, 0, 13),      # M-RoPE prefill
    ("qwen2-vl-7b", 24, 13, 1),      # M-RoPE decode
])
def test_cached_attention_block_matches(arch, w, idx, s):
    rcfg, cfg, _, params, tparams = _setup(arch)
    rng = np.random.default_rng(idx + s)
    b = 2
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    q_pos = np.arange(idx, idx + s, dtype=np.int32)
    pos3d = _positions_3d(b, s, 2) + idx if cfg.mrope else None
    jc, tc = _attn_cache(w, cfg.n_kv_heads, cfg.head_dim, b, idx, 3)
    ap = _layer0(params["layers"]["attn"])
    want, jnew = RL.attention_block(
        ap, jnp.asarray(x), jnp.asarray(q_pos), jnp.asarray(q_pos), rcfg,
        jc, None if pos3d is None else jnp.asarray(pos3d))
    tap = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    got = L.attention_block(
        tap, torch.from_numpy(x), torch.from_numpy(q_pos), cfg, tc,
        None if pos3d is None else torch.from_numpy(pos3d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jnew["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jnew["v"]), **TOL)
    assert int(tc["len"]) == int(jnew["len"]) == idx + s


@pytest.mark.parametrize("causal,window,bq,bkv", [
    (True, 0, 8, 16), (True, 7, 8, 8), (False, 0, 8, 16), (False, 0, 4, 37),
])
def test_blockwise_attention_matches(causal, window, bq, bkv):
    rng = np.random.default_rng(bq + bkv)
    sq, sk = 20, 37
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
    q_pos = np.arange(sk - sq, sk, dtype=np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    want = RL.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), block_q=bq,
        block_kv=bkv, causal=causal, window=window)
    got = L.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)), block_q=bq,
        block_kv=bkv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal:      # streamed blocks equal the whole (Sq, Sk) softmax
        full = L.full_attention(
            *(torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)),
            causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_attention_op_blockwise_branch_matches():
    """A dense config with a 16-key threshold: 40 keys take the blockwise
    branch at the port planner's blocks; the reference, handed the same
    blocks, agrees, and so does full attention (causal)."""
    arch = "llama3.2-1b"
    rcfg = dataclasses.replace(ref_config(arch).reduced(),
                               attn_blockwise_threshold=16)
    cfg = dataclasses.replace(get_model_config(arch).reduced(),
                              attn_blockwise_threshold=16)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    plan = plan_attention(40, 40, 16, dtype_bytes=2)
    want = RL.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                           jnp.asarray(pos), jnp.asarray(pos), rcfg,
                           tile_plan=plan)
    got = L.attention_op(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(k), torch.from_numpy(pos),
                         torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = L.attention_op(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(k), torch.from_numpy(pos),
                          torch.from_numpy(pos), get_model_config(
                              arch).reduced())
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("idx,s", [(None, 9), (0, 9), (9, 1)])
def test_mla_attention_matches(idx, s):
    """Expanded (no cache), absorbed prefill into an empty latent cache,
    absorbed one-token decode over a filled one."""
    rcfg, cfg, _, params, tparams = _setup("deepseek-v2-236b")
    m = cfg.mla
    rng = np.random.default_rng(s)
    b, w = 2, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    start = idx or 0
    q_pos = np.arange(start, start + s, dtype=np.int32)
    ap = _layer0(params["layers"]["attn"])
    tap = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    jc = tc = None
    if idx is not None:
        ckv = np.zeros((b, w, m.kv_lora_rank), np.float32)
        kr = np.zeros((b, w, m.rope_head_dim), np.float32)
        ckv[:, :idx] = rng.standard_normal((b, idx, m.kv_lora_rank))
        kr[:, :idx] = rng.standard_normal((b, idx, m.rope_head_dim))
        jc = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr),
              "len": jnp.asarray(idx, jnp.int32)}
        tc = {"ckv": torch.from_numpy(ckv.copy()),
              "krope": torch.from_numpy(kr.copy()),
              "len": torch.tensor(idx, dtype=torch.int32)}
    want, jnew = RMLA.mla_attention(ap, jnp.asarray(x), jnp.asarray(q_pos),
                                    rcfg, jc)
    got = MLA.mla_attention(tap, torch.from_numpy(x),
                            torch.from_numpy(q_pos), cfg, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if idx is not None:
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(tc[key].numpy(),
                                       np.asarray(jnew[key]), **TOL)
        assert int(tc["len"]) == int(jnew["len"]) == idx + s
    else:          # the two forms compute the same attention
        tc = {"ckv": torch.zeros((b, w, m.kv_lora_rank)),
              "krope": torch.zeros((b, w, m.rope_head_dim)),
              "len": torch.tensor(0, dtype=torch.int32)}
        absorbed = MLA.mla_attention(tap, torch.from_numpy(x),
                                     torch.from_numpy(q_pos), cfg, tc)
        np.testing.assert_allclose(absorbed.numpy(), got.numpy(), **TOL)


# ---------------------------------------------------------------------------
# Cache operations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-large-v3"])
def test_grow_take_and_capacity_match(arch):
    """``cache_capacity``, ``grow_cache`` (growable leaves padded on axis
    2, rings and cross K/V kept) and ``take_slots`` (axis 1 of every leaf
    of two or more dims; ``len`` and ``pos`` whole) on a prefilled cache,
    against the reference's on the same cache."""
    rcfg, cfg, ref, params, tparams = _setup(arch)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 5)
                                    ).astype(np.int32)}
    if cfg.family == "enc_dec":
        batch["enc_embeds"] = rng.standard_normal(
            (3, 7, cfg.d_model)).astype(np.float32)
    _, jc = ref.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        8, dtype=jnp.float32)
    with torch.no_grad():
        _, tc = Model(cfg).prefill(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, 8,
            dtype=torch.float32)
    assert KV.cache_capacity(cfg, tc) == RKV.cache_capacity(rcfg, jc)
    jg, tg = RKV.grow_cache(rcfg, jc, 12), KV.grow_cache(cfg, tc, 12)
    _check_cache(tg, jg)
    for name, leaf in _flat(tg).items():
        if name.split(".")[-1] in KV.GROWABLE_LEAVES:
            # A ring (the window caps Mixtral's 8-token cache) never grows.
            assert leaf.shape[2] == (8 if cfg.sliding_window else 12), name
    _check_cache(KV.take_slots(tg, [2, 0]), RKV.take_slots(jg, [2, 0]))
    assert KV.take_slots(tg, [1])["pos"] == tg["pos"]


# ---------------------------------------------------------------------------
# Model steps, every family
# ---------------------------------------------------------------------------


def _prompt_batch(cfg, rng, b, s):
    if cfg.family == "vlm":
        return {"embeds": (rng.standard_normal((b, s, cfg.d_model)) * 0.5
                           ).astype(np.float32),
                "positions_3d": _positions_3d(b, s, 4)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.family == "enc_dec":
        batch["enc_embeds"] = rng.standard_normal(
            (b, 9, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_then_decode_steps_match(arch):
    """``prefill`` (40 tokens for Mixtral: past its 32-token ring) into a
    48-token cache, then three greedy ``decode_step``s (vlm: all three
    streams at the cache position, as the reference's engine feeds them):
    logits and every cache leaf agree after each call."""
    rcfg, cfg, ref, params, tparams = _setup(arch, seed=1)
    model = Model(cfg)
    rng = np.random.default_rng(2)
    b, s, max_len = 2, (40 if cfg.sliding_window else 12), 48
    batch = _prompt_batch(cfg, rng, b, s)
    lj, jc = ref.prefill(params, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, max_len, dtype=jnp.float32)
    with torch.no_grad():
        lt, tc = model.prefill(tparams, {k: torch.from_numpy(v) for k, v in
                                         batch.items()}, max_len,
                               dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _check_cache(tc, jc)
    for _ in range(3):
        step = {"tokens": np.argmax(np.asarray(lj), -1)[:, None].astype(
            np.int32)}
        if cfg.family == "vlm":
            step["positions_3d"] = np.full((3, b, 1), int(jc["pos"]),
                                           np.int32)
        lj, jc = ref.decode_step(params, jc, {k: jnp.asarray(v) for k, v in
                                              step.items()},
                                 dtype=jnp.float32)
        with torch.no_grad():
            lt, tc = model.decode_step(
                tparams, tc, {k: torch.from_numpy(v) for k, v in
                              step.items()}, dtype=torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        _check_cache(tc, jc)
    assert tc["pos"] == s + 3
