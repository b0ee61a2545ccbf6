"""The port's ``paged_attention`` against the JAX package's Pallas kernel
(interpret mode on the CPU) and its jnp oracle, on the grid of
``tests/test_kernels.py``; and, on a card, the CUDA kernel against its plain
PyTorch version.

Tolerance: float32 1e-4 (blocked-vs-flat summation order), bfloat16 2e-2,
as in ``tests/test_kernels.py``.  Rows with length 0 are compared with the
Pallas kernel (both give zeros) but not with the jnp oracle, whose empty
rows are undefined.
"""

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax: there only the gpu case runs
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention as jax_paged
    from repro.kernels.ref import paged_attention_ref as jax_ref
except ImportError:
    jnp = None
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import paged_attention_ref

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _case(seed, s, h, kv, d, t, p_total, n_logical, max_len):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k = rng.standard_normal((p_total, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((p_total, t, kv, d)).astype(np.float32)
    table = rng.integers(1, p_total, (s, n_logical)).astype(np.int32)
    lengths = rng.integers(0, max_len + 1, (s,)).astype(np.int32)
    lengths[0] = 0                           # always one empty row
    return q, k, v, table, lengths


def _need_jax():
    if jnp is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _both(case, window, t):
    _need_jax()
    mine = paged_attention(*(torch.from_numpy(a) for a in case),
                           window=window, page_tokens=t)
    pallas = jax_paged(*(jnp.asarray(a) for a in case), window=window,
                       page_tokens=t)
    oracle = jax_ref(*(jnp.asarray(a) for a in case), window=window)
    return mine.numpy(), np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("window", [0, 6, 16])
@pytest.mark.parametrize("s,h,kv,d,t", [(3, 4, 2, 16, 8), (2, 4, 4, 32, 16),
                                        (4, 8, 2, 16, 8)])
def test_matches_pallas_kernel_and_oracle(s, h, kv, d, t, window):
    n_logical = 3
    case = _case(s * 31 + window, s, h, kv, d, t, p_total=7,
                 n_logical=n_logical, max_len=n_logical * t)
    mine, pallas, oracle = _both(case, window, t)
    live = case[4] > 0
    np.testing.assert_allclose(mine, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine[live], oracle[live], rtol=1e-4,
                               atol=1e-4)
    assert (mine[~live] == 0).all()


@pytest.mark.parametrize("kv,group", [(3, 2), (5, 1), (6, 4)])
def test_gqa_head_counts_off_the_sublane_multiple(kv, group):
    """The shapes of the Pallas kernel's sublane-pad path (KV not a
    multiple of 8): the port needs no pad, and agrees."""
    h = kv * group
    s, d, t, n_logical = 3, 16, 8, 3
    case = _case(kv * 11 + group, s, h, kv, d, t, p_total=7,
                 n_logical=n_logical, max_len=n_logical * t)
    mine, pallas, oracle = _both(case, 0, t)
    live = case[4] > 0
    assert mine.shape == (s, h, d)
    np.testing.assert_allclose(mine, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine[live], oracle[live], rtol=1e-4,
                               atol=1e-4)


def test_refuses_wrong_page_size():
    _need_jax()
    case = _case(0, 2, 4, 2, 16, 8, 5, 2, 16)
    with pytest.raises(ValueError, match="planned page"):
        jax_paged(*(jnp.asarray(a) for a in case), page_tokens=16)
    with pytest.raises(ValueError, match="planned page"):
        paged_attention(*(torch.from_numpy(a) for a in case), page_tokens=16)


def test_off_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: here, a device
    that is neither CPU nor CUDA, and a CPU/other-device mix, both raise
    without touching the plain version or the launch counter."""
    case = _case(1, 2, 4, 2, 16, 8, 5, 2, 16)
    before = pa_mod.LAUNCHES
    meta = [torch.from_numpy(a).to("meta") for a in case]
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention(*meta, page_tokens=8)
    mixed = [torch.from_numpy(a) for a in case]
    mixed[1] = mixed[1].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention(*mixed, page_tokens=8)
    assert pa_mod.LAUNCHES == before


def test_planned_page_shapes_agree_on_cpu():
    """Pages of 56 tokens (the planned H100 page for llama3.2-1b, not a
    power of two), llama's grouping (G=4, D=64), lengths 0, 1 and many
    pages, with and without a window."""
    t, s, kv, d = 56, 6, 2, 64
    rng = np.random.default_rng(5)
    q = rng.standard_normal((s, 8, d)).astype(np.float32)
    k = rng.standard_normal((20, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((20, t, kv, d)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, 20))[:6]
                      for _ in range(s)]).astype(np.int32)
    lengths = np.array([0, 1, 55, 57, 200, 336], np.int32)
    case = (q, k, v, table, lengths)
    for window in (0, 100):
        mine, pallas, oracle = _both(case, window, t)
        np.testing.assert_allclose(mine, pallas, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mine[1:], oracle[1:], rtol=1e-4,
                                   atol=1e-4)


def test_scrambled_table_matches_dense_attention():
    """Each row's stream scattered through a scrambled page table equals
    the JAX package's dense grouped attention over the same stream, with
    per-row lengths as kv_len masks."""
    _need_jax()
    from repro.models.layers import grouped_attention

    s, h, kv, d, t, n_logical = 3, 4, 2, 16, 8, 4
    rng = np.random.default_rng(7)
    kd = rng.standard_normal((s, n_logical * t, kv, d)).astype(np.float32)
    vd = rng.standard_normal((s, n_logical * t, kv, d)).astype(np.float32)
    q = rng.standard_normal((s, 1, h, d)).astype(np.float32)
    lengths = np.array([5, 17, 32], np.int32)
    table = rng.permutation(np.arange(1, 1 + s * n_logical)).reshape(
        s, n_logical).astype(np.int32)
    pool_k = np.zeros((1 + s * n_logical, t, kv, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    pool_k[table.reshape(-1)] = kd.reshape(s * n_logical, t, kv, d)
    pool_v[table.reshape(-1)] = vd.reshape(s * n_logical, t, kv, d)
    out = paged_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(pool_k),
                          torch.from_numpy(pool_v), torch.from_numpy(table),
                          torch.from_numpy(lengths), page_tokens=t)
    ref = grouped_attention(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
        jnp.asarray(lengths - 1)[:, None], jnp.arange(n_logical * t),
        causal=True, kv_len=jnp.asarray(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[:, 0]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_kernel_matches_plain_version(dtype, window, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    t, s, h, kv, p_total, n_logical = 56, 7, 32, 8, 40, 9
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(p_total, t, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(p_total, t, kv, d, generator=gen).to("cuda", dtype)
    table = torch.randint(1, p_total, (s, n_logical), generator=gen,
                          dtype=torch.int32).to("cuda")
    lengths = torch.tensor([0, 1, 8, 56, 57, 300, n_logical * t],
                           dtype=torch.int32, device="cuda")
    before = pa_mod.LAUNCHES
    out = paged_attention(q, k, v, table, lengths, window=window,
                          page_tokens=t)
    torch.cuda.synchronize()
    assert pa_mod.LAUNCHES == before + 1
    ref = paged_attention_ref(q, k, v, table, lengths, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
