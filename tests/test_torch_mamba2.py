"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against the JAX
package's (``repro.models.mamba2``), and the SSD scan's state in and out.

On the CPU, at ``zamba2-1.2b.reduced()`` (d_model 64, 8 heads of 16,
state 16, chunk 16), with inputs made from a numpy seed and handed to both
packages: ``causal_conv1d`` with and without state, ``ssd_chunked`` with a
random initial state at ragged lengths (y and final state), ``ssd_step``,
and ``mamba2_block`` carrying its cache over two prefill chunks and a
one-token step.  Tolerance: float32 2e-4 (the same scan summed in another
order), as in ``tests/test_kernels.py``.

On a card (``gpu``): ``ssd_scan`` with state, at short calls (8 tokens,
rounded up to one 16-row tc chunk), ragged ones and the cohort engine's
batched prefills (4 x 288, 2 x 1,088), against its plain version; chained
calls against one long call.
"""

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax: there only the gpu cases run
    import jax.numpy as jnp
    from repro.configs import get_model_config as ref_config
    from repro.models import mamba2 as RM
except ImportError:
    jnp = None
from repro_torch.configs import get_model_config
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import ssd_passes_ref, ssd_ref
from repro_torch.kernels.ssd_scan import call_chunk, ssd_scan
from repro_torch.models import mamba2 as M
from repro_torch.models.params import init_params

TOL = dict(rtol=2e-4, atol=2e-4)
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


def _need_jax():
    if jnp is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _cfg():
    return get_model_config("zamba2-1.2b").reduced()


def _ssd_inputs(seed, b, s, h, p, n, init=True):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)) / 2; A = -exp(0.3 N(0, 1));
    a random initial state (B, H, P, N) -- numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    return x, dt, A, Bm, Cm, s0


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# Against the JAX package, float32 on the CPU
# ---------------------------------------------------------------------------


def test_param_specs_match_the_reference():
    _need_jax()
    cfg, rcfg = _cfg(), ref_config("zamba2-1.2b").reduced()
    mine = M.mamba2_param_specs(cfg, cfg.n_layers)
    ref = RM.mamba2_param_specs(rcfg, rcfg.n_layers)
    assert {k: (v.shape, v.init, v.scale) for k, v in mine.items()} == \
        {k: (v.shape, v.init, v.scale) for k, v in ref.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv1d_matches_reference(with_state, s):
    _need_jax()
    rng = np.random.default_rng(s + 10 * with_state)
    c, width = 24, 4
    x = rng.standard_normal((2, s, c)).astype(np.float32)
    w = rng.standard_normal((width, c)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    st = rng.standard_normal((2, width - 1, c)).astype(np.float32) \
        if with_state else None
    out, new = M.causal_conv1d(_t(x), _t(w), _t(b), _t(st))
    rout, rnew = RM.causal_conv1d(_j(x), _j(w), _j(b), _j(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(rnew), **TOL)
    assert new.shape == (2, width - 1, c)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,chunk", [(37, 16), (16, 16), (5, 16), (50, 8)])
def test_ssd_chunked_matches_reference(s, chunk, with_init):
    """Ragged lengths, one or several chunks, from zeros or a random
    state: y and the final state."""
    _need_jax()
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(s * chunk, 2, s, 8, 16, 16,
                                       init=with_init)
    y, fin = M.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                           _t(s0))
    ry, rfin = RM.ssd_chunked(_j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk,
                              _j(s0))
    assert y.shape == (2, s, 8, 16) and fin.shape == (2, 8, 16, 16)
    assert fin.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(rfin), **TOL)


def test_ssd_step_matches_reference():
    _need_jax()
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(3, 2, 1, 8, 16, 16)
    y, new = M.ssd_step(_t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(Bm[:, 0]),
                        _t(Cm[:, 0]), _t(s0))
    ry, rnew = RM.ssd_step(_j(x[:, 0]), _j(dt[:, 0]), _j(A), _j(Bm[:, 0]),
                           _j(Cm[:, 0]), _j(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(rnew), **TOL)


def _block_params(cfg, seed=0):
    """One mixer's parameters as numpy, with dt_bias, A_log, D and the conv
    bias drawn too (their specs start at constants)."""
    specs = M.mamba2_param_specs(cfg)
    tree = init_params(specs, seed, "cpu")
    rng = np.random.default_rng(seed)
    out = {k: v.numpy() for k, v in tree.items()}
    for k in ("dt_bias", "A_log", "D", "conv_b"):
        out[k] = (rng.standard_normal(out[k].shape) * 0.5).astype(np.float32)
    return out


def test_mamba2_block_chunks_and_step_match_reference():
    """Prefill in two chunks (16 then a ragged 7) carrying the cache, then
    a one-token step: outputs and caches equal the reference's, and the
    two chunks equal one 23-token call."""
    _need_jax()
    cfg, rcfg = _cfg(), ref_config("zamba2-1.2b").reduced()
    p = _block_params(cfg, 1)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: _j(v) for k, v in p.items()}
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    s, c = cfg.ssm, cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.state_dim
    heads = cfg.ssm.expand * cfg.d_model // s.head_dim
    cache = {"conv": torch.zeros(2, s.conv_width - 1, c),
             "ssm": torch.zeros(2, heads, s.head_dim, s.state_dim)}
    rcache = {"conv": jnp.zeros((2, s.conv_width - 1, c)),
              "ssm": jnp.zeros((2, heads, s.head_dim, s.state_dim))}
    outs = []
    for lo, hi in ((0, 16), (16, 23), (23, 24)):
        out, cache = M.mamba2_block(tp, _t(h[:, lo:hi]), cfg, cache)
        rout, rcache = RM.mamba2_block(jp, _j(h[:, lo:hi]), rcfg, rcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(rcache[k]), **TOL)
        outs.append(out)
    whole, _ = M.mamba2_block(tp, _t(h[:, :23]), cfg)
    np.testing.assert_allclose(torch.cat(outs[:2], 1).numpy(), whole.numpy(),
                               **TOL)


def test_mamba2_block_one_token_prefill_takes_the_step():
    """A one-token chunk with a cache (a prompt of 16k + 1 tokens) is the
    reference's ssd_step, not the chunked scan."""
    _need_jax()
    cfg, rcfg = _cfg(), ref_config("zamba2-1.2b").reduced()
    p = _block_params(cfg, 4)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    s, c = cfg.ssm, cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.state_dim
    heads = cfg.ssm.expand * cfg.d_model // s.head_dim
    conv = rng.standard_normal((1, s.conv_width - 1, c)).astype(np.float32)
    ssm = rng.standard_normal((1, heads, s.head_dim, s.state_dim)).astype(
        np.float32)
    out, new = M.mamba2_block({k: _t(v) for k, v in p.items()}, _t(h), cfg,
                              {"conv": _t(conv), "ssm": _t(ssm)})
    rout, rnew = RM.mamba2_block({k: _j(v) for k, v in p.items()}, _j(h),
                                 rcfg, {"conv": _j(conv), "ssm": _j(ssm)})
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(new["ssm"].numpy(), np.asarray(rnew["ssm"]),
                               **TOL)


# ---------------------------------------------------------------------------
# The plain versions' state in and out, and the wrapper's chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,cut,chunk", [(40, 8, 16), (33, 17, 8),
                                         (9, 1, 64)])
def test_plain_versions_carry_state(s, cut, chunk):
    """The sequential and the three-pass plain versions give the same y and
    final state from a random initial state, and two calls chained through
    the state give one call's."""
    x, dt, A, Bm, Cm, s0 = (_t(a) for a in _ssd_inputs(s, 1, s, 3, 16, 8))
    y, fin = ssd_ref(x, dt, A, Bm, Cm, init_state=s0, return_final=True)
    yp, finp = ssd_passes_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                              return_final=True)
    torch.testing.assert_close(yp, y, **TOL)
    torch.testing.assert_close(finp, fin, **TOL)
    y1, mid = ssd_ref(x[:, :cut], dt[:, :cut], A, Bm[:, :cut], Cm[:, :cut],
                      init_state=s0, return_final=True)
    y2, fin2 = ssd_passes_ref(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                              Cm[:, cut:], chunk=chunk, init_state=mid,
                              return_final=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(fin2, fin, **TOL)
    # The wrapper's CPU path is the sequential version, state and all.
    yw, finw = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                        return_final=True)
    torch.testing.assert_close(yw, y)
    torch.testing.assert_close(finw, fin)
    assert torch.equal(ssd_scan(x, dt, A, Bm, Cm), ssd_ref(x, dt, A, Bm, Cm))


def test_passes_ref_still_returns_its_states():
    x, dt, A, Bm, Cm, s0 = (_t(a) for a in _ssd_inputs(0, 1, 20, 2, 16, 8))
    y, fin, states, prev, total = ssd_passes_ref(
        x, dt, A, Bm, Cm, chunk=8, init_state=s0, return_final=True,
        return_states=True)
    assert states.shape == prev.shape == (1, 3, 2, 8, 16)
    torch.testing.assert_close(prev[:, 0], s0.transpose(-1, -2))
    last = torch.exp(total[:, -1])[..., None, None] * prev[:, -1] \
        + states[:, -1]
    torch.testing.assert_close(last.transpose(-1, -2), fin)


@pytest.mark.parametrize("dtype,chunk,s,p,n,want", [
    (torch.bfloat16, 256, 8, 64, 64, 16),     # zamba2's prefill chunk
    (torch.bfloat16, 256, 1, 64, 64, 16),
    (torch.bfloat16, 256, 24, 64, 64, 32),    # one chunk, rounded up
    (torch.bfloat16, 128, 1000, 64, 64, 128),
    (torch.bfloat16, 100, 300, 64, 64, 100),  # several chunks: as asked
    (torch.float32, 256, 8, 64, 64, 8),       # simt: no rounding
    (torch.bfloat16, 256, 8, 48, 64, 8),      # P the tc body lacks
    (torch.bfloat16, 256, 250, 128, 128, 250),  # 256 outgrows the block
])
def test_call_chunk(dtype, chunk, s, p, n, want):
    q = call_chunk(dtype, chunk, s, p, n)
    assert q == want
    assert ssd_mod.ssd_path(dtype, q, p, n) == (
        "tc" if want % 16 == 0 and dtype == torch.bfloat16 and p != 48
        else "simt")


def test_kernel_chunk_fits_the_block():
    """zamba2-1.2b's chunk 256 does not fit one tc block at P = N = 64;
    the kernel runs the scan at 128 (and the plain port at 256)."""
    from repro_torch.hw.h100 import h100_spec

    assert M.kernel_chunk(256, 64, 64, 2) == 128
    assert M.kernel_chunk(128, 64, 64, 2) == 128
    assert M.kernel_chunk(256, 64, 64, 4) == 128
    assert M.kernel_chunk(16, 16, 16, 2) == 16
    for q, db in ((128, 2), (128, 4)):
        path = M.chunk_path(db, q, 64, 64)
        assert M.ssd_workset_bytes(q, 64, 64, path) <= h100_spec().smem_bytes


def test_off_cpu_state_never_falls_back():
    """A CUDA-less device or a CPU/other mix raises without touching the
    plain version or the counters, init_state included."""
    x, dt, A, Bm, Cm, s0 = (_t(a) for a in _ssd_inputs(0, 1, 8, 2, 16, 16))
    before = ssd_mod.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x, dt, A, Bm, Cm, init_state=s0.to("meta"),
                 return_final=True)
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan(x, dt, A, Bm, Cm, init_state=s0[:, :1])
    assert ssd_mod.LAUNCHES == before


# ---------------------------------------------------------------------------
# On a card: the kernel with state against its plain version
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _cuda_inputs(seed, b, s, h, p, n, dtype):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(seed, b, s, h, p, n)
    return (_t(x).to("cuda", dtype), _t(dt).cuda(), _t(A).cuda(),
            _t(Bm).to("cuda", dtype), _t(Cm).to("cuda", dtype),
            _t(s0).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 8, 64, 64, 64, 256),       # zamba2's 8-token chunk: tc at 16
    (2, 1, 8, 16, 16, 16),         # a one-token call
    (1, 13, 8, 32, 16, 256),
    (1, 1000, 64, 64, 64, 128),    # ragged over many chunks
    (2, 300, 3, 64, 64, 64),
])
def test_cuda_ssd_scan_with_state(dtype, b, s, h, p, n, chunk):
    """y and the final state from a random initial state, against the
    sequential plain version; bf16 takes tc (short calls rounded up to one
    16-row chunk), float32 simt; two runs are bit-identical."""
    _cuda_or_skip()
    x, dt, A, Bm, Cm, s0 = _cuda_inputs(s + p, b, s, h, p, n, dtype)
    want = "tc" if dtype == torch.bfloat16 else "simt"
    assert ssd_mod.ssd_path(dtype, call_chunk(dtype, chunk, s, p, n), p,
                            n) == want
    counter = f"LAUNCHES_{want.upper()}"
    before = getattr(ssd_mod, counter)
    y, fin = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                      return_final=True)
    y2, fin2 = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                        return_final=True)
    torch.cuda.synchronize()
    assert getattr(ssd_mod, counter) == before + 2
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    ry, rfin = ssd_ref(x, dt, A, Bm, Cm, init_state=s0, return_final=True)
    torch.testing.assert_close(y.float(), ry.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(fin, rfin, **SSD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_chained_short_calls_equal_one_call(dtype):
    """125 calls of 8 tokens, each from the last one's final state, give
    the y and final state of one 1000-token call (zamba2's mixer shape)."""
    _cuda_or_skip()
    x, dt, A, Bm, Cm, s0 = _cuda_inputs(7, 1, 1000, 64, 64, 64, dtype)
    y, fin = ssd_scan(x, dt, A, Bm, Cm, chunk=128, init_state=s0,
                      return_final=True)
    state, parts = s0, []
    for lo in range(0, 1000, 8):
        sl = slice(lo, lo + 8)
        part, state = ssd_scan(
            x[:, sl].contiguous(), dt[:, sl].contiguous(), A,
            Bm[:, sl].contiguous(), Cm[:, sl].contiguous(), chunk=256,
            init_state=state, return_final=True)
        parts.append(part)
    torch.testing.assert_close(torch.cat(parts, 1).float(), y.float(),
                               **SSD_TOL[dtype])
    torch.testing.assert_close(state, fin, **SSD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,zero_init", [
    (4, 288, True),                # zamba2's cohort prefill: 4 x 288
    (2, 1088, True),               # ... and 2 x 1,088
    (2, 64, True),                 # ... and 2 x 64, at chunk 64
    (4, 288, False),               # a batch > 1 from a random state
])
def test_cuda_ssd_scan_at_cohort_prefill_shapes(dtype, b, s, zero_init):
    """The cohort engine's prefill shape for zamba2-1.2b's mixer (64 heads
    of 64, state 64) at batch > 1, from an initial state (zeros, as a
    fresh cohort cache holds, or random) with the final state out, at the
    chunk the model picks: bf16 on tc, float32 on simt, against the plain
    version; two runs bit-identical."""
    _cuda_or_skip()
    x, dt, A, Bm, Cm, s0 = _cuda_inputs(b * s, b, s, 64, 64, 64, dtype)
    if zero_init:
        s0 = torch.zeros_like(s0)
    chunk = M.kernel_chunk(get_model_config("zamba2-1.2b").ssm.chunk, 64,
                           64, dtype.itemsize)
    want = "tc" if dtype == torch.bfloat16 else "simt"
    counter = f"LAUNCHES_{want.upper()}"
    before = getattr(ssd_mod, counter)
    y, fin = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                      return_final=True)
    y2, fin2 = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                        return_final=True)
    torch.cuda.synchronize()
    assert getattr(ssd_mod, counter) == before + 2
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    ry, rfin = ssd_ref(x, dt, A, Bm, Cm, init_state=s0, return_final=True)
    torch.testing.assert_close(y.float(), ry.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(fin, rfin, **SSD_TOL[dtype])
