"""The port's enc-dec family (Whisper: a bidirectional encoder run once per
request, a decoder whose self-attention K/V is paged and whose cross K/V
is per-slot state) against the JAX package's: the model's paged steps and
the paged ``ServeEngine``.

``whisper-large-v3.reduced()``'s admission install (``encode_cross`` then
``reset_slot``), prefill chunks (one slot across three pages, another in
one chunk) and decode step (one slot empty) give the same cross state,
logits and pool as the JAX model's, and a decode step leaves the cross
state bit-identical.  Greedy decode is token-identical between the JAX
paged engine and the port on the CPU, with the same parameters and page
geometry, under chunked and monolithic prefill, on a trace of encoder
lengths (10, 6, 3) over 2 slots in which the shortest backfills the
longest's slot.  Under a pool so small that the younger slot stalls, it
resumes and the tokens equal an unconstrained run's; the engine's
frozen-slot snapshot copies nothing of the cross state.

Tolerance: float32 1e-4 (two frameworks' float32 products differ in
summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.models.model import build_model as ref_build
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServePolicy as RefPolicy
from repro.serve.pages import init_paged_cache as ref_init_cache
from repro.serve.pages import reset_slot as ref_reset_slot
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import ServeEngine, ServePolicy
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.kvcache import kv_token_bytes, request_state_bytes
from repro_torch.serve.pages import init_paged_cache, reset_slot

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-large-v3"
ENC_LENS = (10, 6, 3)
LENS = (8, 21, 12)
NEWS = [2, 6, 3]
#: The same tiny leaf (and the same HBM) on both sides: small pages.
LEAF = 16 << 10


def _frames(cfg, se, rng):
    return (rng.standard_normal((se, cfg.d_model)) * 0.02).astype(np.float32)


def _prompts(cfg, seed=0, enc_lens=ENC_LENS, lens=LENS):
    rng = np.random.default_rng(seed)
    return [{"enc_embeds": _frames(cfg, se, rng),
             "tokens": rng.integers(0, cfg.vocab_size, n, dtype=np.int32)}
            for se, n in zip(enc_lens, lens)]


def _cross(cache):
    return {k: cache["state"][k].clone() for k in
            ("cross_k", "cross_v", "enc_len")}


def test_prefill_chunks_then_decode_match():
    """Slot 0 (10 encoder frames) prefills 20 tokens in chunks of 8, 8 and
    4 (three pages), slot 2 (6 frames) one chunk of 6; then one decode step
    over all three slots (slot 1 empty, encoder length 0).  The installed
    cross state, the logits after each call and the pool agree with the
    JAX model's, and the decode step leaves the cross state
    bit-identical."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_model_config(ARCH).reduced()
    ref_model, model = ref_build(rcfg, remat="none"), Model(cfg)
    params = ref_model.init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    t, p_total, n_logical, enc_max = 8, 10, 4, 10
    jcache = ref_init_cache(rcfg, ref_model, 3, p_total, t, n_logical,
                            jnp.float32, enc_len=enc_max)
    tcache = init_paged_cache(cfg, 3, p_total, t, n_logical, torch.float32,
                              "cpu", enc_len=enc_max)
    nd = cfg.enc_dec.n_decoder_layers
    for name in ("k", "v"):
        assert tuple(tcache["pool"][name].shape) == \
            tuple(jcache["pool"][name].shape) == \
            (nd, p_total, t, cfg.n_kv_heads, cfg.head_dim)
    for name in ("cross_k", "cross_v", "enc_len"):
        assert tuple(tcache["state"][name].shape) == \
            tuple(jcache["state"][name].shape), name
    rng = np.random.default_rng(6)
    frames = {0: _frames(cfg, 10, rng), 2: _frames(cfg, 6, rng)}
    for slot, f in frames.items():
        ckv = ref_model.encode_cross(params, {"enc_embeds": jnp.asarray(
            f)[None]}, dtype=jnp.float32)
        jcache = ref_reset_slot(rcfg, ref_model, jcache, slot, cross_kv=ckv,
                                enc_len=f.shape[0])
        with torch.no_grad():
            tckv = model.encode_cross(tparams, {"enc_embeds": torch.from_numpy(
                f)[None]}, dtype=torch.float32)
        tcache = reset_slot(cfg, tcache, slot, cross_kv=tckv,
                            enc_len=f.shape[0])

    def check(names):
        for part, name in names:
            np.testing.assert_allclose(
                tcache[part][name].numpy(), np.asarray(jcache[part][name]),
                **TOL, err_msg=name)

    check([("state", "cross_k"), ("state", "cross_v"), ("state", "enc_len")])
    assert not tcache["state"]["cross_k"][:, 2, 6:].any()    # zero padding
    table = np.array([[2, 5, 7, 9], [0] * 4, [1, 3, 0, 0]], np.int32)
    jcache["table"], tcache["table"] = jnp.asarray(table), \
        torch.from_numpy(table)
    prompts = {0: rng.integers(0, cfg.vocab_size, 20).astype(np.int32),
               2: rng.integers(0, cfg.vocab_size, 6).astype(np.int32)}
    last = {}
    for slot, start, stop in ((0, 0, 8), (2, 0, 6), (0, 8, 16),
                              (0, 16, 20)):
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
        check([("pool", "k"), ("pool", "v")])
        last[slot] = int(np.argmax(lt.numpy()))

    pos = np.array([20, 0, 6], np.int32)
    toks = np.array([[last[0]], [0], [last[2]]], np.int32)
    jcache["pos"], tcache["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    before = _cross(tcache)
    lj, jcache = ref_model.decode_step_paged(
        params, jcache, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32)
    with torch.no_grad():
        lt, tcache = model.decode_step_paged(
            tparams, tcache, {"tokens": torch.from_numpy(toks)},
            dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert torch.isfinite(lt).all()
    check([("pool", "k"), ("pool", "v"), ("state", "cross_k"),
           ("state", "cross_v")])
    for name, buf in before.items():
        assert torch.equal(tcache["state"][name], buf), name
    np.testing.assert_array_equal(tcache["pos"].numpy(), pos + 1)

    # A 4-frame request backfills slot 0: its rows past 4 are zeroed, the
    # other slots' rows are untouched.
    f = _frames(cfg, 4, rng)
    ckv = ref_model.encode_cross(params, {"enc_embeds": jnp.asarray(f)[None]},
                                 dtype=jnp.float32)
    jcache = ref_reset_slot(rcfg, ref_model, jcache, 0, cross_kv=ckv,
                            enc_len=4)
    with torch.no_grad():
        tckv = model.encode_cross(
            tparams, {"enc_embeds": torch.from_numpy(f)[None]},
            dtype=torch.float32)
    tcache = reset_slot(cfg, tcache, 0, cross_kv=tckv, enc_len=4)
    check([("state", "cross_k"), ("state", "cross_v"), ("state", "enc_len")])
    assert not tcache["state"]["cross_v"][:, 0, 4:].any()
    assert torch.equal(tcache["state"]["cross_k"][:, 2],
                       before["cross_k"][:, 2])


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _pair(leaf, **pol):
    """The JAX paged engine and the port's, on the same parameters, leaf
    and policy."""
    rcfg = ref_config(ARCH).reduced()
    ref_spec = chip_spec(vmem_bytes=leaf, vmem_reserved_bytes=0)
    ref = RefEngine(rcfg, _host_mesh(),
                    policy=RefPolicy(batching="paged", **pol), spec=ref_spec)
    cfg = get_model_config(ARCH).reduced()
    mine = ServeEngine(
        cfg, ServePolicy(batching="paged", **pol),
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                 "cpu"),
        spec=h100_spec(smem_bytes=leaf, hbm_bytes=ref_spec.hbm_bytes),
        device="cpu")
    return cfg, ref, mine


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_greedy_tokens_identical_to_jax_paged_engine(prefill):
    """Encoder lengths (10, 6, 3) on 2 slots: the first request ends
    first and the 3-frame one backfills its 10-frame slot, so that slot's
    cross rows past 3 must be zeroed and masked."""
    cfg, ref, mine = _pair(LEAF, max_new_tokens=4, max_len=64, max_slots=2,
                           prefill=prefill)
    prompts = _prompts(cfg)
    outs_ref = ref.generate(prompts, max_new_tokens=NEWS)
    outs = mine.generate(prompts, max_new_tokens=NEWS)
    assert outs == outs_ref
    assert [len(o) for o in outs] == NEWS
    for key in ("page_tokens", "pages_total", "pages_per_slot",
                "prefill_chunks", "decode_steps", "backfills",
                "pages_allocated", "pages_released", "peak_pages"):
        assert mine.metrics[key] == ref.metrics[key], key
    assert list(mine.metrics["interleave"]) == list(ref.metrics["interleave"])
    assert mine.metrics["backfills"] >= 1
    assert mine.metrics["pages_allocated"] == mine.metrics["pages_released"]
    # The page's bytes are the decoder's self-attention K/V only.
    assert mine.page.page_bytes == mine.page.page_tokens * \
        cfg.enc_dec.n_decoder_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 4


def test_stalled_slot_resumes_and_snapshot_skips_cross_state(monkeypatch):
    """Three usable pages for two growing slots: the younger slot has no
    younger victim and stalls, riding through decode ticks, and resumes
    once the older request ends within its pages.  The tokens equal the
    JAX engine's under the same pool and the port's under an
    unconstrained one.  The frozen-slot snapshot copies no row of the
    cross state (enc_dec has no ``STATE_GROUPS``), and no decode tick
    changes it."""
    cfg = get_model_config(ARCH).reduced()
    probe = ServeEngine(cfg, ServePolicy(max_len=128),
                        spec=h100_spec(smem_bytes=LEAF), device="cpu")
    t = probe.page.page_tokens
    _, ref, tight = _pair(LEAF, max_len=4 * t, max_slots=2,
                          kv_budget_bytes=probe.page.page_bytes * 3)
    prompts = _prompts(cfg, seed=5, enc_lens=(9, 4), lens=(8, 8))
    news = [int(1.25 * t) - 8, 2 * t - 8]
    snapshots, steps = [], []
    real_rows, real_decode = engine_mod.slot_rows, tight.steps.decode

    def rows_spy(buf, slots):
        snapshots.append(tuple(buf.shape))
        return real_rows(buf, slots)

    def decode_spy(params, cache, batch):
        before = _cross(cache)
        out = real_decode(params, cache, batch)
        steps.append(all(torch.equal(cache["state"][k], v)
                         for k, v in before.items()))
        return out

    monkeypatch.setattr(engine_mod, "slot_rows", rows_spy)
    monkeypatch.setattr(tight, "steps", tight.steps.__class__(
        decode=decode_spy, prefill_chunk=tight.steps.prefill_chunk,
        model=tight.steps.model, encode=tight.steps.encode))
    outs = tight.generate(prompts, max_new_tokens=news)
    assert tight.metrics["stalls"] >= 1 and tight.metrics["evictions"] == 0
    assert outs == ref.generate(prompts, max_new_tokens=news)
    free = ServeEngine(cfg, ServePolicy(max_len=4 * t, max_slots=2),
                       params=tight.params, spec=h100_spec(smem_bytes=LEAF),
                       device="cpu")
    assert outs == free.generate(prompts, max_new_tokens=news)
    assert [len(o) for o in outs] == news
    assert snapshots == [] and steps and all(steps)
    assert tight.metrics["pages_allocated"] == \
        tight.metrics["pages_released"]


def test_requests_carry_their_cross_state_bytes():
    """A request's fixed state is its cross K/V, 2 x nd x Se x KV x D
    values, as the reference's memory model says; the per-token bytes are
    the decoder layers' self-attention K/V; the request's group is
    (prompt, encoder) lengths."""
    from repro.serve import kvcache as RK

    for cfg, rcfg in ((get_model_config(ARCH), ref_config(ARCH)),
                      (get_model_config(ARCH).reduced(),
                       ref_config(ARCH).reduced())):
        for se in (0, 3, 1500):
            assert request_state_bytes(cfg, se, 2) == \
                RK.request_state_bytes(rcfg, se, 2) == \
                2 * cfg.enc_dec.n_decoder_layers * se * cfg.n_kv_heads * \
                cfg.head_dim * 2
        assert kv_token_bytes(cfg, 2) == RK.kv_token_bytes(rcfg, 2)
    assert kv_token_bytes(get_model_config(ARCH), 2) == (163840, 32, 20)
    assert request_state_bytes(get_model_config(ARCH), 1500, 2) == \
        245_760_000
    cfg = get_model_config(ARCH).reduced()
    engine = ServeEngine(cfg, ServePolicy(max_len=64),
                         spec=h100_spec(smem_bytes=LEAF), device="cpu")
    req = engine._make_request(_prompts(cfg)[1], 3)
    assert req.state_bytes == request_state_bytes(cfg, 6, 4) > 0
    assert req.group == (21, 6) and req.prompt_len == 21
