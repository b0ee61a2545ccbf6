"""The port's enc-dec model pieces (Whisper) against the JAX package's, at
``whisper-large-v3.reduced()`` (2 encoder and 2 decoder layers, d_model
64, 4 heads of 16 over 4 KV heads).

The parameter tree and its specs; the unpaged attention the encoder and
cross-attention run (``attn_mask`` and ``full_attention`` with a per-row
valid length, a row at 0 among them; ``attention_block`` without a cache,
non-causal); the encoder stack (``Model._encode``), the cross projections
(``cross_kv``, ``encode_cross``) and cross-attention (``_cross_attn`` over
the cross K/V, whole or zero-padded with per-row lengths).  The JAX parameters reach the port through numpy and
``params_from_numpy``.

Tolerance: float32 1e-4 (two frameworks' float32 products differ in
summation order only).
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
from repro_torch.models.params import init_params, params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-large-v3"


def _setup(seed=0):
    rcfg = ref_config(ARCH).reduced()
    cfg = get_model_config(ARCH).reduced()
    ref = ref_build(rcfg, remat="none")
    params = ref.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return rcfg, cfg, ref, params, tparams


def _frames(cfg, b, se, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, se, cfg.d_model)) * 0.02).astype(
        np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_param_specs_follow_the_reference():
    """Same paths, shapes, axes, inits and scales as the JAX package's
    enc-dec tree: ``enc_layers`` (the decoder-layer body), ``dec_layers``
    with ``cross`` and ``ln3``, ``enc_final_norm``; the JAX weights carry
    over leaf for leaf, and the seeded init fills every leaf of the spec's
    shape."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    ref = _flat(ref_build(rcfg, remat="none").param_specs())
    mine = _flat(Model(cfg).param_specs())
    assert sorted(ref) == sorted(mine)
    for k in ref:
        assert (tuple(ref[k].shape), tuple(ref[k].axes), ref[k].init,
                ref[k].scale) == (tuple(mine[k].shape), tuple(mine[k].axes),
                                  mine[k].init, mine[k].scale), k
    assert {"enc_layers.attn.wq", "dec_layers.cross.wk", "dec_layers.ln3",
            "enc_final_norm", "lm_head"} <= set(mine)
    assert mine["dec_layers.cross.wv"].shape == (
        cfg.enc_dec.n_decoder_layers, cfg.d_model,
        cfg.n_kv_heads * cfg.head_dim)

    _, _, _, params, tparams = _setup()
    for path, leaf in _flat(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_array_equal(_flat(tparams)[path].numpy(), leaf)
    seeded = _flat(init_params(Model(cfg).param_specs(), 3, "cpu"))
    for path, spec in mine.items():
        leaf = seeded[path]
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert torch.isfinite(leaf).all(), path
    with pytest.raises(KeyError, match="dec_layers.cross"):
        bad = jax.tree.map(np.asarray, params)
        del bad["dec_layers"]["cross"]
        params_from_numpy(bad, cfg, "cpu")


#: (name, q_pos shape, k_pos, causal, window, kv_len): the masks the
#: enc-dec paths build, and the causal/window ones beside them.
MASKS = [
    ("decode_rows", "rows", "plain", False, 0, [5, 0, 9]),
    ("chunk_scalar", "shared", "plain", False, 0, 7),
    ("chunk_row_vector", "shared", "plain", False, 0, [7]),
    ("encoder", "shared", "plain", False, 0, None),
    ("causal_window", "shared", "ring", True, 3, None),
    ("causal_rows_len", "rows", "plain", True, 0, [6, 2, 9]),
]


@pytest.mark.parametrize("name,qshape,kkind,causal,window,kv_len", MASKS,
                         ids=[m[0] for m in MASKS])
def test_attn_mask_and_full_attention_match(name, qshape, kkind, causal,
                                            window, kv_len):
    """``attn_mask`` equals the reference's, and ``full_attention`` under
    it: finite everywhere, equal to the JAX output, and a row whose valid
    length is 0 attends uniformly (over zero-padded V: zeros)."""
    rng = np.random.default_rng(1)
    sq = 1 if qshape == "rows" else 4
    b = len(kv_len) if isinstance(kv_len, list) else \
        (3 if qshape == "rows" else 1)
    sk, h, d = 10, 4, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    if isinstance(kv_len, list):
        for i, n in enumerate(kv_len):      # the cross state's zero padding
            k[i, n:] = 0
            v[i, n:] = 0
    q_pos = (np.array([[4], [0], [8]], np.int32) if qshape == "rows"
             else np.arange(5, 5 + sq, dtype=np.int32))
    k_pos = (np.arange(sk, dtype=np.int32) if kkind == "plain"
             else np.array([8, 9, -1, -1, 4, 5, 6, 7, 2, 3], np.int32))
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    ref_mask = RL.attn_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), causal,
                            window, None if kl is None else jnp.asarray(kl))
    mask = L.attn_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                       causal, window,
                       None if kl is None else torch.from_numpy(kl))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    ref = RL.full_attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                            causal=causal, window=window,
                            kv_len=None if kl is None else jnp.asarray(kl))
    out = L.full_attention(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
                           causal=causal, window=window,
                           kv_len=None if kl is None
                           else torch.from_numpy(kl))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if name == "decode_rows":
        np.testing.assert_array_equal(out[1].numpy(), 0)


def test_attention_block_without_cache_matches():
    """The encoder's attention: fused projections, RoPE at the frame
    positions, non-causal attention within the sequence (and the causal
    variant), against the reference's ``attention_block`` with no cache."""
    rcfg, cfg, _, params, tparams = _setup()
    ap = jax.tree.map(lambda a: a[0], params["enc_layers"]["attn"])
    tap = {k: v[0] for k, v in tparams["enc_layers"]["attn"].items()}
    x = _frames(cfg, 2, 12, 2) * 50
    pos = np.arange(12, dtype=np.int32)
    for causal in (False, True):
        ref, _ = RL.attention_block(ap, jnp.asarray(x), jnp.asarray(pos),
                                    jnp.asarray(pos), rcfg, None,
                                    causal=causal)
        out = L.attention_block(tap, torch.from_numpy(x),
                                torch.from_numpy(pos), cfg, causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_blockwise_branch_waits_for_its_slice():
    """Past ``attn_blockwise_threshold`` keys with no valid length and a
    multi-token query, ``attention_op`` goes blockwise at the blocks the
    port's planner gives the shape; handed the same blocks, the
    reference's blockwise branch gives the same output, causal or not,
    over GQA-repeated keys.  One query token, or a valid length, stays on
    full attention."""
    import dataclasses

    from repro_torch.core.autotile import plan_attention

    rcfg = dataclasses.replace(ref_config(ARCH).reduced(),
                               attn_blockwise_threshold=16)
    cfg = dataclasses.replace(get_model_config(ARCH).reduced(),
                              attn_blockwise_threshold=16)
    rng = np.random.default_rng(5)
    sq, sk = 24, 40
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    q_pos = np.arange(sk - sq, sk, dtype=np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    plan = plan_attention(sq, sk, 16, dtype_bytes=2)
    for causal in (False, True):
        want = RL.attention_op(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(q_pos),
                               jnp.asarray(k_pos), rcfg, causal=causal,
                               tile_plan=plan)
        got = L.attention_op(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), cfg, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tpos = torch.from_numpy(k_pos)
    assert L.attention_op(tq[:, :1], tk, tk, tpos[:1], tpos, cfg,
                          causal=False).shape == (2, 1, 4, 16)


def test_encode_and_cross_kv_match():
    """The encoder stack (non-causal ``_tf_layer`` over ``enc_layers``,
    then ``enc_final_norm``) and every decoder layer's cross K/V equal the
    reference's, for a batch of two 13-frame inputs; ``encode_cross``
    composes the two."""
    rcfg, cfg, ref, params, tparams = _setup()
    model = Model(cfg)
    frames = _frames(cfg, 2, 13, 3)
    enc_ref = ref._encode(params, jnp.asarray(frames), jnp.float32)
    with torch.no_grad():
        enc = model._encode(tparams, torch.from_numpy(frames),
                            torch.float32)
        ck, cv = model.cross_kv(tparams, enc)
        ck2, cv2 = model.encode_cross(
            tparams, {"enc_embeds": torch.from_numpy(frames)},
            dtype=torch.float32)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), **TOL)
    rk, rv = ref.cross_kv(params, enc_ref)
    nd = cfg.enc_dec.n_decoder_layers
    assert tuple(ck.shape) == tuple(rk.shape) == (
        nd, 2, 13, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(ck.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(cv.numpy(), np.asarray(rv), **TOL)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


@pytest.mark.parametrize("padded", [False, True])
def test_cross_attn_matches(padded):
    """Cross-attention of decoder rows over the encoder's cross K/V: whole,
    or zero-padded to the longest encoder with one valid length a row (one
    of them 0, whose output is zeros)."""
    rcfg, cfg, ref, params, tparams = _setup()
    model = Model(cfg)
    enc_ref = ref._encode(params, jnp.asarray(_frames(cfg, 3, 11, 4)),
                          jnp.float32)
    rk, rv = ref.cross_kv(params, enc_ref)
    k, v = np.array(rk[1]), np.array(rv[1])
    lens = None
    if padded:
        lens = np.array([11, 0, 6], np.int32)
        mask = (np.arange(11)[None, :] < lens[:, None])[:, :, None, None]
        k, v = k * mask, v * mask
    cp = jax.tree.map(lambda a: a[1], params["dec_layers"]["cross"])
    tcp = {k_: v_[1] for k_, v_ in tparams["dec_layers"]["cross"].items()}
    x = _frames(cfg, 3, 1, 5) * 50
    q_pos = np.array([[3], [0], [7]], np.int32)
    k_pos = np.arange(11, dtype=np.int32)
    ref_out = ref._cross_attn(
        cp, jnp.asarray(x), None, jnp.asarray(q_pos), jnp.asarray(k_pos),
        kv=(jnp.asarray(k), jnp.asarray(v)),
        kv_len=None if lens is None else jnp.asarray(lens))
    with torch.no_grad():
        out = model._cross_attn(
            tcp, torch.from_numpy(x), torch.from_numpy(q_pos),
            torch.from_numpy(k_pos), (torch.from_numpy(k),
                                      torch.from_numpy(v)),
            None if lens is None else torch.from_numpy(lens))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    if padded:
        np.testing.assert_array_equal(out[1].numpy(), 0)
