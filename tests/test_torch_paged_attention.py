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


# ---------------------------------------------------------------------------
# The split body's decomposition (``paged_attention_split_ref``), routing,
# split count and shared memory
# ---------------------------------------------------------------------------


def _split_case(seed, s, h, kv, d, t, n_logical, lengths):
    """A table far wider than the rows' streams (so most splits hold no
    live key), every row with its own scrambled pages."""
    rng = np.random.default_rng(seed)
    p_total = 1 + s * n_logical
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k = rng.standard_normal((p_total, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((p_total, t, kv, d)).astype(np.float32)
    table = (1 + rng.permutation(s * n_logical)).reshape(
        s, n_logical).astype(np.int32)
    return q, k, v, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("split_pages", [1, 2, 5])
@pytest.mark.parametrize("window", [0, 6, 21])
def test_split_ref_matches_pallas_kernel_and_oracle(split_pages, window):
    """Splits of 1, 2 and 5 pages of 8 tokens over a 12-page table: rows
    empty, of one token, ending exactly on a split boundary (16, 40 and 80
    tokens are whole 1-, 2- and 5-page splits), and long; windows of 6 and
    21 start inside a split.  Against the Pallas kernel (interpret mode)
    and the jnp oracle."""
    _need_jax()
    from repro_torch.kernels.ref import paged_attention_split_ref

    t = 8
    case = _split_case(split_pages * 7 + window, 6, 8, 2, 16, t, 12,
                       [0, 1, 16, 40, 80, 93])
    mine = paged_attention_split_ref(*(torch.from_numpy(a) for a in case),
                                     window=window, split_pages=split_pages)
    pallas = jax_paged(*(jnp.asarray(a) for a in case), window=window,
                       page_tokens=t)
    oracle = jax_ref(*(jnp.asarray(a) for a in case), window=window)
    live = case[4] > 0
    np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(mine.numpy()[live], np.asarray(oracle)[live],
                               rtol=1e-4, atol=1e-4)
    assert (mine.numpy()[~live] == 0).all()


@pytest.mark.parametrize("split_pages", [1, 2, 5])
def test_split_partials_of_splits_without_a_live_key(split_pages):
    """A split past the row's last key, or wholly before its window, is the
    empty partial (m = -inf, l = 0, acc = 0); the others hold a finite max
    and a positive sum."""
    from repro_torch.kernels.ref import paged_attention_split_ref

    t, window = 8, 10
    lengths = [0, 30, 57]
    case = _split_case(3, 3, 4, 2, 16, t, 12, lengths)
    out, m, l, acc = paged_attention_split_ref(
        *(torch.from_numpy(a) for a in case), window=window,
        split_pages=split_pages, return_partials=True)
    splits = -(-12 // split_pages)
    assert m.shape == (3, 2, splits, 2) and acc.shape == (3, 2, splits, 2, 16)
    span = split_pages * t
    for r, n in enumerate(lengths):
        lo, hi = max(0, n - window), n - 1
        for c in range(splits):
            live = n > 0 and c * span <= hi and (c + 1) * span - 1 >= lo
            if live:
                assert torch.isfinite(m[r, :, c]).all() and (l[r, :, c] > 0
                                                             ).all()
            else:
                assert torch.isinf(m[r, :, c]).all() and (m[r, :, c] < 0
                                                          ).all()
                assert (l[r, :, c] == 0).all() and (acc[r, :, c] == 0).all()
    ref = paged_attention_ref(*(torch.from_numpy(a) for a in case),
                              window=window)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,d,t,group,body", [
    (torch.bfloat16, 64, 56, 4, "split"),
    (torch.bfloat16, 128, 216, 16, "split"),
    (torch.bfloat16, 128, 232, 16, "simt"),      # two pages do not fit
    (torch.bfloat16, 64, 8, 1, "split"),
    (torch.float32, 64, 56, 4, "simt"),
    (torch.bfloat16, 32, 56, 4, "simt"),
    (torch.bfloat16, 64, 60, 4, "simt"),
    (torch.bfloat16, 64, 264, 4, "simt"),
    (torch.bfloat16, 64, 56, 32, "simt"),
    (torch.bfloat16, 576, 96, 128, "mla"),       # DeepSeek-V2's latent
    (torch.bfloat16, 576, 8, 4, "mla"),
    (torch.bfloat16, 576, 96, 256, "simt"),      # past 8 head tiles
    (torch.float32, 576, 96, 128, "simt"),
])
def test_body_selection(dtype, d, t, group, body):
    assert pa_mod.paged_path(dtype, d, t, group) == body


def test_a_body_that_cannot_take_the_shape_raises():
    """``path="split"`` on float32 raises, whatever the device, and moves
    no counter; ``path="simt"`` is always allowed."""
    case = _case(1, 2, 4, 2, 64, 8, 5, 2, 16)
    before = (pa_mod.LAUNCHES, pa_mod.LAUNCHES_SPLIT, pa_mod.LAUNCHES_SIMT)
    args = [torch.from_numpy(a) for a in case]
    with pytest.raises(ValueError, match="split body cannot take"):
        paged_attention(*args, page_tokens=8, path="split")
    with pytest.raises(ValueError, match="split_pages"):
        paged_attention(*args, page_tokens=8, split_pages=0)
    assert paged_attention(*args, page_tokens=8, path="simt").shape == \
        (2, 4, 64)
    assert (pa_mod.LAUNCHES, pa_mod.LAUNCHES_SPLIT,
            pa_mod.LAUNCHES_SIMT) == before


def test_split_count_from_shapes_alone():
    """The split comes from rows, KV heads, table width and page size: it
    takes no ``lengths`` (reading them would sync the stream).  At
    llama3.2-1b decode (8 rows x 8 KV heads, 74 pages of 56 tokens) a
    split is 2 pages, 37 splits; one 56-token prefill chunk gets 8 pages,
    10 splits.  Every split plan covers the table, with no split left
    empty by construction, at most ``MAX_SPLIT_PAGES`` pages and at least
    64 tokens a split where the table has them."""
    import inspect

    assert list(inspect.signature(pa_mod.split_plan).parameters) == \
        ["rows", "n_kv", "table_width", "page_tokens", "spec"]
    assert pa_mod.split_plan(8, 8, 74, 56) == (37, 2)
    assert pa_mod.split_plan(56, 8, 74, 56) == (10, 8)
    for rows in (1, 3, 8, 56, 500):
        for n_kv in (1, 2, 8):
            for width in (1, 5, 74, 512):
                for t in (8, 16, 56, 256):
                    splits, pages = pa_mod.split_plan(rows, n_kv, width, t)
                    assert 1 <= pages <= pa_mod.MAX_SPLIT_PAGES
                    assert (splits - 1) * pages < width <= splits * pages
                    assert pages * t >= 64 or pages == width \
                        or pages == pa_mod.MAX_SPLIT_PAGES
    assert pa_mod.split_workspace(8, 8, 37, 4, 64) == (
        (8, 8, 37, 4, 64), (8, 8, 37, 4, 2))


def test_smem_bytes_follow_the_sources_layout():
    """``smem_bytes(group, head_dim, page_tokens)``: the split body stages
    two bf16 pages of one KV head -- at llama3.2-1b's planned page (56
    tokens, D 64, 8 KV heads) exactly the 1/KV share of the two buffered
    pages of all KV heads that the page level prices -- plus 1,024 B of
    alignment slack, two mbarriers and 16 table entries; where the warps'
    float32 states outgrow the ring, the ring grows to them.  The simt body
    stages fixed tiles whatever the page."""
    from repro_torch.core.plan import PAGE_BUFFERING

    tok_bytes_all_heads = 2 * 8 * 64 * 2          # K + V, 8 KV heads, bf16
    ring = PAGE_BUFFERING * 56 * tok_bytes_all_heads // 8
    assert ring == 28_672
    assert pa_mod.smem_bytes(4, 64, 56) == 1024 + ring + 2 * 8 + 16 * 4 \
        == 29_776
    assert pa_mod.smem_bytes(4, 128, 216) == 1024 + 2 * 2 * 216 * 128 * 2 \
        + 80 <= 232_448 < pa_mod.smem_bytes(4, 128, 232)
    merge = 4 * (16 * 128 + 2 * 16) * 4
    assert pa_mod.smem_bytes(16, 128, 8) == 1024 + merge + 80
    for t in (8, 56, 112):
        assert pa_mod.smem_bytes(4, 64, t, "simt") == 36_144


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("t", [8, 56, 64, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_split_body(d, t, group, window):
    """The split body on the card against the plain version: ragged
    lengths (empty, one token, ending on a page and on a split boundary,
    long), splits of the planned size and of 1 and 3 pages, and two runs on
    the same inputs bit-identical.  At D 128 two 256-token pages outgrow a
    block, and that shape runs (and is checked) on the simt body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kv, n_logical = 4, 24
    h = kv * group
    lengths = [0, 1, t, 2 * t, 3 * t + 5, 7 * t - 1, n_logical * t]
    s = len(lengths)
    gen = torch.Generator().manual_seed(d + t + group + window)
    p_total = 1 + s * n_logical
    q = torch.randn(s, h, d, generator=gen).to("cuda", torch.bfloat16)
    k = torch.randn(p_total, t, kv, d, generator=gen).to("cuda",
                                                         torch.bfloat16)
    v = torch.randn(p_total, t, kv, d, generator=gen).to("cuda",
                                                         torch.bfloat16)
    table = (1 + torch.randperm(s * n_logical, generator=gen)).reshape(
        s, n_logical).to("cuda", torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ref = paged_attention_ref(q, k, v, table, lens, window=window).float()
    body = pa_mod.paged_path(torch.bfloat16, d, t, group)
    assert body == ("simt" if (d, t) == (128, 256) else "split")
    counter = "LAUNCHES_" + body.upper()
    for split_pages in (None, 1, 3):
        before = (getattr(pa_mod, counter), pa_mod.LAUNCHES)
        out = paged_attention(q, k, v, table, lens, window=window,
                              page_tokens=t, split_pages=split_pages)
        again = paged_attention(q, k, v, table, lens, window=window,
                                page_tokens=t, split_pages=split_pages)
        torch.cuda.synchronize()
        assert (getattr(pa_mod, counter), pa_mod.LAUNCHES) == \
            (before[0] + 2, before[1] + 2)
        assert torch.equal(out, again)
        err = (out.float() - ref).abs()
        assert bool((err <= 2e-2 * (1 + ref.abs())).all()), \
            (split_pages, float(err.max()))
        assert not out[0].float().abs().any()


def _check_group1_shape(dtype, shape, t, h, kv, d, n_logical, seed):
    """The split body (bf16) or simt (float32) at one group-1 serving
    shape, over the engine's ``n_logical``-page table: decode rows of
    ragged lengths, or one page of prefill rows over one table row.  Both
    agree with the plain version, empty rows are zero, and two bf16 runs
    are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(seed)
    if shape == "decode":
        lengths = [0, 1, 8, 57, 300, 1000, 1056, 64]
        need = [-(-n // t) for n in lengths]
        p_total = 1 + sum(need)
        perm = (1 + torch.randperm(p_total - 1, generator=gen)).int()
        table = torch.zeros(len(lengths), n_logical, dtype=torch.int32)
        at = 0
        for i, n in enumerate(need):
            table[i, :n] = perm[at:at + n]
            at += n
    else:
        lengths = list(range(8 * t + 1, 9 * t + 1))
        p_total = 1 + 9
        row = torch.zeros(n_logical, dtype=torch.int32)
        row[:9] = (1 + torch.randperm(9, generator=gen)).int()
        table = row[None].expand(len(lengths), n_logical).contiguous()
    s = len(lengths)
    q = torch.randn(s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(p_total, t, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(p_total, t, kv, d, generator=gen).to("cuda", dtype)
    table = table.to("cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    body = pa_mod.paged_path(dtype, d, t, h // kv)
    assert body == ("split" if dtype == torch.bfloat16 else "simt")
    counter = "LAUNCHES_" + body.upper()
    before = getattr(pa_mod, counter)
    out = paged_attention(q, k, v, table, lens, page_tokens=t)
    again = paged_attention(q, k, v, table, lens, page_tokens=t)
    torch.cuda.synchronize()
    assert getattr(pa_mod, counter) == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, k, v, table, lens).float()
    live = lens > 0
    torch.testing.assert_close(out.float()[live], ref[live], **TOL[dtype])
    assert not out[~live].float().abs().any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["decode", "prefill"])
def test_cuda_zamba2_shared_attention_shapes(dtype, shape):
    """zamba2-1.2b's shared attention block: 32 query heads over 32 KV
    heads (group 1, the m16 tile 15/16 padding), D 64, the planned 8-token
    page, over the engine's 512-page table; decode rows of ragged lengths
    and one 8-row prefill chunk over one table row."""
    _check_group1_shape(dtype, shape, t=8, h=32, kv=32, d=64, n_logical=512,
                        seed=8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["decode", "prefill"])
def test_cuda_whisper_decoder_shapes(dtype, shape):
    """whisper-large-v3's decoder self-attention: 20 query heads over 20
    KV heads (group 1), D 64, the planned 16-token page, over the engine's
    256-page table; decode rows of ragged lengths and one 16-row prefill
    chunk over one table row."""
    _check_group1_shape(dtype, shape, t=16, h=20, kv=20, d=64, n_logical=256,
                        seed=18)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["decode", "prefill"])
def test_cuda_mixtral_window_shapes(dtype, shape):
    """mixtral-8x7b's attention: 32 query heads over 8 KV heads (group 4),
    D 128, the planned 24-token page and the 4096-token sliding window,
    over the engine's 342-page table (8192 tokens) whose entries below the
    window point at the null page, as window reclaim leaves them; decode
    rows some past the window, and one page of prefill rows over one
    table.  bf16 takes the split body, float32 simt; both agree with the
    plain version and two bf16 runs are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    t, h, kv, d, n_logical, window = 24, 32, 8, 128, 342, 4096
    gen = torch.Generator().manual_seed(24)

    def dead(n):                    # pages wholly below the window: null
        return max(0, n - 1 - window) // t

    if shape == "decode":
        lengths = [0, 1, 700, 4096, 4097, 4400, 5000, 8000]
        spans = [(dead(n), -(-n // t)) for n in lengths]
    else:
        pos0 = 183 * t
        lengths = list(range(pos0 + 1, pos0 + t + 1))
        spans = [(dead(lengths[0]), -(-lengths[-1] // t))]
    p_total = 1 + sum(b - a for a, b in spans)
    perm = (1 + torch.randperm(p_total - 1, generator=gen)).int()
    rows = torch.zeros(len(spans), n_logical, dtype=torch.int32)
    at = 0
    for i, (a, b) in enumerate(spans):
        rows[i, a:b] = perm[at:at + b - a]
        at += b - a
    table = rows if shape == "decode" else \
        rows.expand(len(lengths), n_logical).contiguous()
    lo = spans[-1][0]               # the last row's null entries
    assert lo > 0 and (table[-1, :lo] == 0).all()
    s = len(lengths)
    q = torch.randn(s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(p_total, t, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(p_total, t, kv, d, generator=gen).to("cuda", dtype)
    table = table.to("cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    body = pa_mod.paged_path(dtype, d, t, h // kv)
    assert body == ("split" if dtype == torch.bfloat16 else "simt")
    counter = "LAUNCHES_" + body.upper()
    before = getattr(pa_mod, counter)
    out = paged_attention(q, k, v, table, lens, window=window, page_tokens=t)
    again = paged_attention(q, k, v, table, lens, window=window,
                            page_tokens=t)
    torch.cuda.synchronize()
    assert getattr(pa_mod, counter) == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, k, v, table, lens, window=window).float()
    live = lens > 0
    torch.testing.assert_close(out.float()[live], ref[live], **TOL[dtype])


# ---------------------------------------------------------------------------
# The mla body (DeepSeek-V2's latent: D 576, 128 query heads, K = V)
# ---------------------------------------------------------------------------


def test_mla_split_plan_and_shared_memory():
    """The mla body's splits come from shapes alone: at DeepSeek-V2 decode
    (8 rows x 8 head tiles, 43 pages of 96 tokens) one page a split, 43
    splits; a 96-row prefill chunk (768 blocks, more than the 132 SMs)
    does not split, so it needs no workspace.  Its block stages the 16-head
    q tile, one ring of two 32-token tiles when K and V are one tensor (two
    otherwise) and the tile's scores, whatever the page and group.  The
    simt body takes the same shape in 16-head, 16-token tiles (148,736 B
    where the whole group would need 919,296 B)."""
    assert pa_mod.mla_split_plan(8, 1, 128, 43, 96) == (43, 1)
    assert pa_mod.mla_split_plan(96, 1, 128, 43, 96) == (1, 43)
    assert pa_mod.mla_split_plan(2, 1, 4, 5, 8)[0] >= 1
    row = 2 * (576 + 8)
    assert pa_mod.smem_bytes(128, 576, 96, "mla") == \
        16 * row + 2 * 32 * row + 16 * 40 * 4 == 96_000
    assert pa_mod.smem_bytes(4, 576, 8, "mla", shared_kv=False) == \
        96_000 + 2 * 32 * row <= 232_448
    assert pa_mod.simt_plan(128, 576) == (16, 16)
    assert pa_mod.smem_bytes(128, 576, 96, "simt") == 148_736
    assert 4 * (2 * 128 * 576 + 64 * 577 + 64 * 576 + 128 * 64
                + 3 * 128) == 919_296
    assert pa_mod.simt_plan(4, 64) == (4, 64)


def _mla_case(dtype, shape, shared=True, seed=17):
    """DeepSeek-V2's paged MLA call at its published widths: q (S, 128,
    576), the latent pool (P, 96, 1, 576) as K and V, the engine's 43-page
    table (4096 tokens).  Decode: 8 rows of ragged lengths; prefill: one
    96-token chunk at 961..1056 over one table."""
    t, h, d, n_logical = 96, 128, 576, 43
    gen = torch.Generator().manual_seed(seed)
    if shape == "decode":
        lengths = [0, 1, 57, 300, 700, 1056, 1000, 64]
        need = [-(-n // t) for n in lengths]
        p_total = 1 + sum(need)
        perm = (1 + torch.randperm(p_total - 1, generator=gen)).int()
        table = torch.zeros(len(lengths), n_logical, dtype=torch.int32)
        at = 0
        for i, n in enumerate(need):
            table[i, :n] = perm[at:at + n]
            at += n
    else:
        lengths = list(range(10 * t + 1, 11 * t + 1))
        p_total = 1 + 11
        row = torch.zeros(n_logical, dtype=torch.int32)
        row[:11] = (1 + torch.randperm(11, generator=gen)).int()
        table = row[None].expand(len(lengths), n_logical).contiguous()
    q = torch.randn(len(lengths), h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(p_total, t, 1, d, generator=gen).to("cuda", dtype)
    v = k if shared else torch.randn(p_total, t, 1, d,
                                     generator=gen).to("cuda", dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, table.to("cuda"), lens


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["decode", "prefill"])
def test_cuda_mla_shapes(dtype, shape):
    """DeepSeek-V2's MLA call (128 query heads over the one latent "KV
    head", D 576, K = V, 96-token pages): bf16 takes the mla body (split at
    decode, one split at prefill), float32 the simt body in 16-head tiles;
    both agree with the plain version, empty rows are zero, and two bf16
    runs are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, table, lens = _mla_case(dtype, shape)
    body = pa_mod.paged_path(dtype, 576, 96, 128)
    assert body == ("mla" if dtype == torch.bfloat16 else "simt")
    counter = "LAUNCHES_" + body.upper()
    before = getattr(pa_mod, counter)
    out = paged_attention(q, k, v, table, lens, page_tokens=96)
    again = paged_attention(q, k, v, table, lens, page_tokens=96)
    torch.cuda.synchronize()
    assert getattr(pa_mod, counter) == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, k, v, table, lens).float()
    live = lens > 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (out.float() - ref)[live].abs()
    assert bool((err <= tol * (1 + ref[live].abs())).all()), \
        float(err.max())
    assert not out[~live].float().abs().any()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("split_pages", [None, 1, 3, 16])
def test_cuda_mla_body_splits_windows_and_distinct_kv(split_pages, shared,
                                                      window):
    """The mla body at DeepSeek-V2's decode shape over splits of 1, 3 and
    16 pages (the 16-page split covers rows whose keys cross pages inside
    one block), a window that starts inside a page, and K and V as two
    tensors (staged in two rings) as well as one: against the plain
    version, reruns bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, table, lens = _mla_case(torch.bfloat16, "decode", shared,
                                     seed=split_pages or 0)
    before = pa_mod.LAUNCHES_MLA
    out = paged_attention(q, k, v, table, lens, window=window,
                          page_tokens=96, split_pages=split_pages)
    again = paged_attention(q, k, v, table, lens, window=window,
                            page_tokens=96, split_pages=split_pages)
    torch.cuda.synchronize()
    assert pa_mod.LAUNCHES_MLA == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, k, v, table, lens, window=window).float()
    live = lens > 0
    err = (out.float() - ref)[live].abs()
    assert bool((err <= 2e-2 * (1 + ref[live].abs())).all()), \
        float(err.max())
