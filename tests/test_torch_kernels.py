"""The port's ``matmul_cc``, ``flash_attention`` and ``ssd_scan`` against
the JAX package's Pallas kernels (interpret mode on the CPU) and its jnp
oracles, on subsets of the grids of ``tests/test_kernels.py``; and, on a
card, each CUDA kernel against its plain PyTorch version.

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs are the same float32 values rounded to bf16 on each side (both
round to nearest even, so both see identical bits).

Tolerances, as in ``tests/test_kernels.py``: matmul and attention float32
1e-4 and bf16 2e-2 (blocked-vs-flat summation order; bf16 rounding of the
output and of the probabilities), SSD float32 2e-4 and bf16 5e-2 (the
chunked form against the sequential recurrence).

Causal attention with Sq > Sk leaves the first Sq - Sk rows without a key:
the Pallas kernel's output there depends on ``block_kv`` (with Sq=40,
Sk=24, block_q=16, row 0 matched the oracle at block_kv=8 and was 0.16
away at block_kv=16), so such rows are undefined and only rows that see at
least one key are compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax: there only the gpu cases run
    import jax.numpy as jnp
    from repro.core.autotile import AttentionTilePlan as JaxAttnPlan
    from repro.core.autotile import MatmulTilePlan as JaxMMPlan
    from repro.kernels import flash_attention as jax_flash
    from repro.kernels import matmul_cc as jax_matmul
    from repro.kernels import ssd_scan as jax_ssd
    from repro.kernels.ref import flash_attention_ref as jax_fa_ref
    from repro.kernels.ref import matmul_ref as jax_mm_ref
    from repro.kernels.ref import ssd_ref as jax_ssd_ref
except ImportError:
    jnp = None
from repro_torch.core.autotile import AttentionTilePlan, MatmulTilePlan
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import matmul_cc as mm_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_cc import matmul_cc
from repro_torch.kernels.ref import flash_attention_ref, matmul_ref, ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan

MM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture(autouse=True)
def _no_tuning_artifact(monkeypatch, tmp_path):
    """Plans here are the analytic ones, whatever artifact a machine has."""
    monkeypatch.setenv("REPRO_TORCH_TUNING", str(tmp_path / "absent.json"))


def _need_jax():
    if jnp is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(arr)
    j = jnp.asarray(arr)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# matmul_cc
# ---------------------------------------------------------------------------

MM_SHAPES = [(128, 128, 128), (72, 130, 50), (8, 512, 8), (300, 100, 200)]


def _mm_plans(m, k, n, order="cc"):
    kw = dict(m=m, k=k, n=n, bm=min(64, m), bk=min(64, k), bn=min(64, n),
              order=order, np=1, est_vmem_bytes=0,
              strategy="cache_conscious")
    return MatmulTilePlan(**kw), JaxMMPlan(**kw)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_cc_matches_pallas_and_oracle(m, k, n, dtype):
    _need_jax()
    rng = np.random.default_rng(m * k + n)
    a, ja = _pair(rng.standard_normal((m, k)).astype(np.float32), dtype)
    b, jb = _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
    mine_plan, jax_plan = _mm_plans(m, k, n)
    mine = matmul_cc(a, b, plan=mine_plan)
    assert mine.dtype == a.dtype and mine.shape == (m, n)
    pallas = jax_matmul(ja, jb, plan=jax_plan, interpret=True)
    np.testing.assert_allclose(_np(mine), _np(pallas), **MM_TOL[dtype])
    np.testing.assert_allclose(_np(mine), _np(jax_mm_ref(ja, jb)),
                               **MM_TOL[dtype])


@pytest.mark.parametrize("order", ["cc", "srrc"])
def test_matmul_orders_agree_with_pallas(order):
    _need_jax()
    rng = np.random.default_rng(11)
    a, ja = _pair(rng.standard_normal((192, 256)).astype(np.float32),
                  "float32")
    b, jb = _pair(rng.standard_normal((256, 320)).astype(np.float32),
                  "float32")
    mine_plan, jax_plan = _mm_plans(192, 256, 320, order=order)
    mine = matmul_cc(a, b, plan=mine_plan)
    pallas = jax_matmul(ja, jb, plan=jax_plan, interpret=True)
    np.testing.assert_allclose(_np(mine), _np(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(mine), _np(a @ b), rtol=1e-4, atol=1e-4)


def test_matmul_planned_tile_and_ops():
    """With no plan the wrapper takes the planner's tile; ``ops.matmul``
    is the same function."""
    _need_jax()
    from repro.kernels.ops import matmul as jax_ops_matmul

    rng = np.random.default_rng(3)
    a, ja = _pair(rng.standard_normal((96, 80)).astype(np.float32),
                  "float32")
    b, jb = _pair(rng.standard_normal((80, 112)).astype(np.float32),
                  "float32")
    mine = ops.matmul(a, b, order="srrc")
    np.testing.assert_allclose(_np(mine), _np(matmul_cc(a, b)), rtol=0,
                               atol=0)
    np.testing.assert_allclose(
        _np(mine), _np(jax_ops_matmul(ja, jb, order="srrc", interpret=True)),
        rtol=1e-4, atol=1e-4)


def test_matmul_refuses_a_plan_for_other_shapes():
    plan = MatmulTilePlan(m=16, k=8, n=32, bm=16, bk=8, bn=32, order="cc",
                          np=1, est_vmem_bytes=0, strategy="cache_conscious")
    with pytest.raises(ValueError, match="plan is for"):
        matmul_cc(torch.zeros(16, 8), torch.zeros(8, 24), plan=plan)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FA_SHAPES = [
    # (B, H, Sq, Sk, D)
    (1, 2, 128, 128, 64),
    (2, 1, 64, 256, 32),     # decode-ish: kv longer than q
    (1, 1, 100, 100, 64),    # ragged
]


def _fa_case(seed, b, h, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]


def _fa_plans(sq, sk, d, bq, bkv):
    kw = dict(q_len=sq, kv_len=sk, head_dim=d, block_q=bq, block_kv=bkv,
              np=1, est_vmem_bytes=0)
    return AttentionTilePlan(**kw), JaxAttnPlan(**kw)


@pytest.mark.parametrize("b,h,sq,sk,d", FA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_oracle(b, h, sq, sk, d, causal,
                                                   dtype):
    _need_jax()
    (q, jq), (k, jk), (v, jv) = _fa_case(sq * sk, b, h, sq, sk, d, dtype)
    mine_plan, jax_plan = _fa_plans(sq, sk, d, 64, 64)
    mine = flash_attention(q, k, v, causal=causal, plan=mine_plan)
    pallas = jax_flash(jq, jk, jv, causal=causal, plan=jax_plan,
                       interpret=True)
    oracle = jax_fa_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(mine), _np(pallas), **MM_TOL[dtype])
    np.testing.assert_allclose(_np(mine), _np(oracle), **MM_TOL[dtype])


@pytest.mark.parametrize("block_kv", [8, 16])
def test_rows_without_a_key_are_not_compared(block_kv):
    """Causal, Sq=40 > Sk=24: rows 0..15 see no key and are undefined (the
    Pallas kernel's row 0 moves with block_kv); rows 16.. agree."""
    _need_jax()
    sq, sk, d = 40, 24, 16
    (q, jq), (k, jk), (v, jv) = _fa_case(40, 1, 1, sq, sk, d, "float32")
    mine_plan, jax_plan = _fa_plans(sq, sk, d, 16, block_kv)
    mine = _np(flash_attention(q, k, v, causal=True, plan=mine_plan))
    pallas = _np(jax_flash(jq, jk, jv, causal=True, plan=jax_plan,
                           interpret=True))
    seen = np.arange(sq) + (sk - sq) >= 0
    assert seen.sum() == 24
    np.testing.assert_allclose(mine[:, :, seen], pallas[:, :, seen],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        mine[:, :, seen], _np(jax_fa_ref(jq, jk, jv))[:, :, seen],
        rtol=1e-4, atol=1e-4)


def test_flash_attention_block_sweep():
    """Different block choices leave the result where the Pallas kernel's
    is, for each choice."""
    _need_jax()
    (q, jq), (k, jk), (v, jv) = _fa_case(4, 1, 1, 128, 128, 64, "float32")
    ref = _np(flash_attention_ref(q, k, v))
    for bq, bkv in [(32, 32), (64, 128), (128, 64), (8, 8)]:
        mine_plan, jax_plan = _fa_plans(128, 128, 64, bq, bkv)
        mine = _np(flash_attention(q, k, v, plan=mine_plan))
        pallas = _np(jax_flash(jq, jk, jv, plan=jax_plan, interpret=True))
        np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mine, pallas, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{bq}x{bkv}")


def test_clamped_plan_is_reported_as_run():
    """A block larger than the sequence is clamped, and the returned plan
    says so, in both packages."""
    _need_jax()
    (q, jq), (k, jk), (v, jv) = _fa_case(5, 1, 2, 100, 60, 32, "float32")
    mine_plan, jax_plan = _fa_plans(100, 60, 32, 128, 128)
    mine, eff = flash_attention(q, k, v, plan=mine_plan, return_plan=True)
    pallas, jax_eff = jax_flash(jq, jk, jv, plan=jax_plan, interpret=True,
                                return_plan=True)
    assert (eff.block_q, eff.block_kv) == (100, 60)
    assert (eff.block_q, eff.block_kv) == (jax_eff.block_q,
                                           jax_eff.block_kv)
    assert eff.source == jax_eff.source == "analytic+clamped"
    np.testing.assert_allclose(_np(mine), _np(pallas), rtol=1e-4, atol=1e-4)
    # An unclamped plan comes back as it went in.
    fit, _ = _fa_plans(100, 60, 32, 64, 32)
    _, same = flash_attention(q, k, v, plan=fit, return_plan=True)
    assert same == fit


def test_ops_attention_matches_jax_ops():
    _need_jax()
    from repro.kernels.ops import attention as jax_ops_attention

    (q, jq), (k, jk), (v, jv) = _fa_case(6, 1, 2, 48, 48, 32, "float32")
    np.testing.assert_allclose(
        _np(ops.attention(q, k, v)),
        _np(jax_ops_attention(jq, jk, jv, interpret=True)),
        rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

SSD_SHAPES = [
    # (B, S, H, P, N, chunk)
    (1, 64, 2, 16, 16, 16),
    (1, 100, 2, 16, 8, 32),   # ragged seq vs chunk
    (1, 64, 4, 64, 64, 64),
]


def _ssd_case(seed, b, s, h, p, n, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    xs = _pair(x, dtype)
    bs = _pair(bm, dtype)
    cs = _pair(cm, dtype)
    dts = _pair(dt, "float32")
    As = _pair(a, "float32")
    return ([xs[0], dts[0], As[0], bs[0], cs[0]],
            [xs[1], dts[1], As[1], bs[1], cs[1]])


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas_and_oracle(b, s, h, p, n, chunk, dtype):
    _need_jax()
    mine_in, jax_in = _ssd_case(s * p, b, s, h, p, n, dtype)
    mine = ssd_scan(*mine_in, chunk=chunk)
    assert mine.dtype == mine_in[0].dtype and mine.shape == (b, s, h, p)
    pallas = jax_ssd(*jax_in, chunk=chunk, interpret=True)
    x, dt, A, Bm, Cm = jax_in
    oracle = jax_ssd_ref(x.astype(jnp.float32), dt, A,
                         Bm.astype(jnp.float32), Cm.astype(jnp.float32))
    np.testing.assert_allclose(_np(mine), _np(pallas), **SSD_TOL[dtype])
    np.testing.assert_allclose(_np(mine), _np(oracle), **SSD_TOL[dtype])


def test_ssd_chunk_invariance_and_ops():
    """The chunk is a pure performance knob, in the Pallas kernel and in
    the port; ``ops.ssd`` is the same function."""
    _need_jax()
    mine_in, jax_in = _ssd_case(9, 1, 96, 2, 16, 16, "float32")
    mine = _np(ssd_scan(*mine_in, chunk=16))
    for c in (16, 32, 64):
        np.testing.assert_allclose(_np(ops.ssd(*mine_in, chunk=c)), mine,
                                   rtol=0, atol=0)
        np.testing.assert_allclose(
            mine, _np(jax_ssd(*jax_in, chunk=c, interpret=True)),
            rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_passes_ref_matches_pallas_and_chunked(chunk):
    """The tc body's three passes (``ssd_passes_ref``) against the Pallas
    kernel (interpret mode) and ``repro.models.mamba2.ssd_chunked``, with a
    ragged last chunk (100 steps); the state after pass 2's last chunk is
    ``ssd_chunked``'s final state (its layout is (B, H, P, N))."""
    _need_jax()
    from repro.models.mamba2 import ssd_chunked

    from repro_torch.kernels.ref import ssd_passes_ref

    mine_in, jax_in = _ssd_case(chunk, 2, 100, 3, 16, 16, "float32")
    y, states, prev, total = ssd_passes_ref(*mine_in, chunk=chunk,
                                            return_states=True)
    nc = -(-100 // chunk)
    assert states.shape == prev.shape == (2, nc, 3, 16, 16)
    assert total.shape == (2, nc, 3) and not prev[:, 0].any()
    pallas = jax_ssd(*jax_in, chunk=chunk, interpret=True)
    y_ch, final = ssd_chunked(*jax_in, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(pallas), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(y), _np(y_ch), rtol=2e-4, atol=2e-4)
    last = torch.exp(total[:, -1])[..., None, None] * prev[:, -1] \
        + states[:, -1]
    np.testing.assert_allclose(_np(last.transpose(-1, -2)), _np(final),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,chunk,p,n,body", [
    (torch.bfloat16, 128, 64, 64, "tc"),
    (torch.bfloat16, 256, 128, 128, "tc"),
    (torch.bfloat16, 16, 16, 16, "tc"),
    (torch.float32, 128, 64, 64, "simt"),
    (torch.bfloat16, 100, 64, 64, "simt"),       # chunk not a whole 16
    (torch.bfloat16, 512, 64, 64, "simt"),
    (torch.bfloat16, 128, 48, 64, "simt"),
    (torch.bfloat16, 128, 64, 8, "simt"),
])
def test_ssd_body_selection(dtype, chunk, p, n, body):
    assert ssd_mod.ssd_path(dtype, chunk, p, n) == body


def test_ssd_tc_grid_and_workset():
    """At zamba2-1.2b's mixer over 4096 tokens (64 heads of 64, state 64)
    the tc body's chunk-state and output launches give the card at least
    132 blocks at batch 1 (8 heads a block); its working set is the pass-3
    block the source lays out (one 128-row chunk, 8 warps), and the
    planner's analytic chunk is 128: at 256 the block outgrows shared
    memory."""
    from repro_torch.models.mamba2 import choose_chunk, ssd_workset_bytes

    # Blocks of passes 1 and 3: chunks x head groups (x panels of 128).
    heads = max(d for d in range(1, 9) if 64 % d == 0)
    chunks, groups = 4096 // 128, 64 // heads
    assert heads == 8 and chunks * groups == 256 >= 132
    q, p, n, r = 128, 64, 64, 128
    pass3 = 2 * (q * (n + 8) + r * (n + 8) + q * (p + 8)
                 + 2 * n * (p + 8)) + 4 * r * (q + 4) + 4 * 2 * 8 * q
    assert ssd_workset_bytes(q, p, n) == pass3 == 149_504
    assert pass3 <= 232_448 < ssd_workset_bytes(256, p, n)
    assert choose_chunk(4096, 64, 64, 64, dtype_bytes=2, use_tuned=False) \
        == 128
    # The state workspace at chunk 128: (B, nc, H, N, P) float32.
    assert 32 * 64 * 64 * 64 * 4 == 33_554_432


# ---------------------------------------------------------------------------
# Routing: CPU -> plain version, anything else -> kernel or raise
# ---------------------------------------------------------------------------


def test_off_cpu_tensors_never_fall_back():
    """A device that is neither CPU nor CUDA, or a CPU/other mix, raises in
    every wrapper without touching the plain version or the counters."""
    before = (mm_mod.LAUNCHES, fa_mod.LAUNCHES, ssd_mod.LAUNCHES)
    a = torch.zeros(16, 16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        matmul_cc(a, torch.zeros(16, 16))
    q = torch.zeros(1, 1, 16, 16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 16, 2, 16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x, torch.zeros(1, 16, 2), torch.zeros(2),
                 torch.zeros(1, 16, 8), torch.zeros(1, 16, 8))
    assert (mm_mod.LAUNCHES, fa_mod.LAUNCHES, ssd_mod.LAUNCHES) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_body_that_cannot_take_the_shape_raises(dtype):
    """``path="wgmma"`` on a shape the tensor-core body does not take
    (float32; bf16 with K = 130; attention at D = 32) raises, whatever the
    device, and moves no counter; ``path="simt"`` is always allowed."""
    before = (mm_mod.LAUNCHES, fa_mod.LAUNCHES)
    a, b = torch.zeros(16, 130, dtype=dtype), torch.zeros(130, 16,
                                                           dtype=dtype)
    with pytest.raises(ValueError, match="wgmma body cannot take"):
        matmul_cc(a, b, path="wgmma")
    q = torch.zeros(1, 1, 16, 32, dtype=dtype)
    with pytest.raises(ValueError, match="wgmma body cannot take"):
        flash_attention(q, q, q, path="wgmma")
    assert matmul_cc(a, b, path="simt").shape == (16, 16)
    assert (mm_mod.LAUNCHES, fa_mod.LAUNCHES) == before


def test_library_name_follows_included_headers(monkeypatch, tmp_path):
    """A built library's name hashes its source and every ``csrc`` header
    it includes (headers of headers too), so an edited header rebuilds
    the kernels that include it and no others."""
    from repro_torch.kernels import _build

    (tmp_path / "inner.cuh").write_text("// inner v1\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "a.cu").write_text('#include "outer.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert _build._headers((tmp_path / "a.cu").read_bytes()) == (
        tmp_path / "inner.cuh", tmp_path / "outer.cuh")
    (tmp_path / "inner.cuh").write_text("// inner v2\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] == before["b"]
    # The real sources: the two tensor-core kernels include hopper.cuh.
    monkeypatch.undo()
    for name in ("matmul_cc", "flash_attention"):
        src = (_build.CSRC / f"{name}.cu").read_bytes()
        assert _build.CSRC / "hopper.cuh" in _build._headers(src)


# ---------------------------------------------------------------------------
# On a card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(72, 130, 50), (300, 100, 200),
                                   (512, 384, 640)])
def test_cuda_matmul_matches_plain_version(dtype, m, k, n):
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=gen).to("cuda", dtype)
    b = (torch.randn(k, n, generator=gen) / k ** 0.5).to("cuda", dtype)
    before = mm_mod.LAUNCHES
    cc = matmul_cc(a, b)
    plan = dataclasses.replace(mm_mod.leaf_matmul_plan(
        m, k, n, dtype_bytes=a.element_size()), order="srrc")
    srrc = matmul_cc(a, b, plan=plan)
    torch.cuda.synchronize()
    assert mm_mod.LAUNCHES == before + 2
    assert torch.equal(cc, srrc)
    tol = MM_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(cc.float(), matmul_ref(a, b).float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d", FA_SHAPES + [(1, 2, 8, 512, 128),
                                                     (1, 1, 40, 24, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain_version(dtype, b, h, sq, sk, d,
                                                    causal):
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(sq * sk + d)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to("cuda", dtype)
               for s in (sq, sk, sk))
    before = fa_mod.LAUNCHES
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    seen = (torch.arange(sq, device="cuda") + sk - sq >= 0) if causal \
        else torch.ones(sq, dtype=torch.bool, device="cuda")
    tol = MM_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(out[:, :, seen].float(),
                               ref[:, :, seen].float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["cc", "srrc"])
@pytest.mark.parametrize("m,k,n,tile", [
    (200, 136, 264, None),            # ragged in M, K and N, multiples of 8
    (200, 136, 264, (64, 64, 64)),
    (200, 136, 264, (64, 64, 192)),
    (72, 8, 520, (128, 128, 64)),     # one K step, boxes past every edge
    (512, 384, 640, (128, 64, 256)),
])
def test_cuda_matmul_wgmma_path(order, m, k, n, tile):
    """bf16 shapes with K and N multiples of 8 take the tensor-core body:
    its counter moves, the simt one does not, cc and srrc agree bit for
    bit and the result is the plain version's."""
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(m * n + k)
    a = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
    b = (torch.randn(k, n, generator=gen) / k ** 0.5).to("cuda",
                                                         torch.bfloat16)
    assert mm_mod.matmul_path(m, k, n, a.dtype) == "wgmma"
    plan = mm_mod.leaf_matmul_plan(m, k, n, dtype_bytes=2)
    if tile is not None:
        plan = dataclasses.replace(plan, bm=tile[0], bk=tile[1], bn=tile[2])
    plan = dataclasses.replace(plan, order=order)
    before = (mm_mod.LAUNCHES_WGMMA, mm_mod.LAUNCHES_SIMT, mm_mod.LAUNCHES)
    out = matmul_cc(a, b, plan=plan)
    cc = matmul_cc(a, b, plan=dataclasses.replace(plan, order="cc"))
    torch.cuda.synchronize()
    assert (mm_mod.LAUNCHES_WGMMA, mm_mod.LAUNCHES_SIMT, mm_mod.LAUNCHES) \
        == (before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(out, cc)
    torch.testing.assert_close(out.float(), matmul_ref(a, b).float(),
                               **MM_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,sq,sk,blocks", [
    (1, 3, 100, 300, None),           # Sq < Sk, both off every block
    (2, 2, 300, 130, None),           # Sq > Sk: causal rows without keys
    (1, 2, 200, 200, (64, 128)),
    (1, 2, 190, 333, (128, 64)),
])
def test_cuda_flash_attention_wgmma_path(causal, d, b, h, sq, sk, blocks):
    """bf16 at D 64 and 128 takes the tensor-core body: its counter moves,
    the simt one does not, and the rows that see a key agree with the
    plain version."""
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(sq * sk + d)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to("cuda",
                                                         torch.bfloat16)
               for s in (sq, sk, sk))
    assert fa_mod.attention_path(sq, sk, d, q.dtype) == "wgmma"
    plan = None
    if blocks is not None:
        plan = dataclasses.replace(
            fa_mod.plan_attention(sq, sk, d, dtype_bytes=2),
            block_q=blocks[0], block_kv=blocks[1])
    before = (fa_mod.LAUNCHES_WGMMA, fa_mod.LAUNCHES_SIMT, fa_mod.LAUNCHES)
    out = flash_attention(q, k, v, causal=causal, plan=plan)
    torch.cuda.synchronize()
    assert (fa_mod.LAUNCHES_WGMMA, fa_mod.LAUNCHES_SIMT, fa_mod.LAUNCHES) \
        == (before[0] + 1, before[1], before[2] + 1)
    ref = flash_attention_ref(q, k, v, causal=causal)
    seen = (torch.arange(sq, device="cuda") + sk - sq >= 0) if causal \
        else torch.ones(sq, dtype=torch.bool, device="cuda")
    torch.testing.assert_close(out[:, :, seen].float(),
                               ref[:, :, seen].float(),
                               **MM_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES + [(2, 300, 3, 64,
                                                           64, 128)])
def test_cuda_ssd_scan_matches_plain_version(dtype, b, s, h, p, n, chunk):
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(s * p)
    x = torch.randn(b, s, h, p, generator=gen).to("cuda", dtype)
    dt = (torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
          * 0.5).to("cuda")
    A = (-torch.exp(torch.randn(h, generator=gen) * 0.3)).to("cuda")
    Bm = torch.randn(b, s, n, generator=gen).to("cuda", dtype)
    Cm = torch.randn(b, s, n, generator=gen).to("cuda", dtype)
    before = ssd_mod.LAUNCHES
    out = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.LAUNCHES == before + 1
    ref = ssd_ref(x, dt, A, Bm, Cm)
    tol = SSD_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("b,s,h,p,n", [(1, 300, 3, 64, 64),
                                       (2, 1000, 8, 32, 16),
                                       (1, 517, 2, 128, 128),
                                       (1, 520, 16, 16, 32)])
def test_cuda_ssd_tc_body(b, s, h, p, n, chunk):
    """The tc body on the card against the plain version and against the
    simt body on the same inputs, chunks 64, 128 and 256 with ragged ends;
    where the chunk's block outgrows shared memory (P = N = 128 at 256) the
    wrapper raises instead."""
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(s + chunk)
    x = torch.randn(b, s, h, p, generator=gen).to("cuda", torch.bfloat16)
    dt = (torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
          * 0.5).to("cuda")
    A = (-torch.exp(torch.randn(h, generator=gen) * 0.3)).to("cuda")
    Bm = torch.randn(b, s, n, generator=gen).to("cuda", torch.bfloat16)
    Cm = torch.randn(b, s, n, generator=gen).to("cuda", torch.bfloat16)
    assert ssd_mod.ssd_path(torch.bfloat16, chunk, p, n) == "tc"
    if ssd_mod.kernel_smem_bytes(chunk, p, n) > 232_448:
        with pytest.raises(ValueError, match="shared memory"):
            ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        return
    before = (ssd_mod.LAUNCHES_TC, ssd_mod.LAUNCHES)
    out = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    again = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    simt = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, path="simt") \
        if ssd_mod.kernel_smem_bytes(chunk, p, n, "simt") <= 232_448 else None
    torch.cuda.synchronize()
    assert ssd_mod.LAUNCHES_TC == before[0] + 2
    assert torch.equal(out, again)
    ref = ssd_ref(x, dt, A, Bm, Cm).float()
    err = (out.float() - ref).abs()
    assert bool((err <= 5e-2 * (1 + ref.abs())).all()), float(err.max())
    if simt is not None:
        err = (out.float() - simt.float()).abs()
        assert bool((err <= 5e-2 * (1 + ref.abs())).all()), float(err.max())
