"""The port's tile planner against the JAX package's, and on the H100.

Algorithm 1's core gives the same ``np`` in both packages for the same
budget, line and footprint estimator.  On ``h100_spec()`` every tile and
attention plan fits one block's shared memory and the REG level and keeps
Hopper's granules; the grid covers the problem; at the full-width shapes
``chip_smoke.py`` runs, every sweep keeps the analytic centre (where the
TPU working-set model, given Hopper's 232,448 B, keeps none); and the
decode page plan is unchanged (56 tokens, 74 pages a slot).
"""

import math
import re
from pathlib import Path

import pytest
import torch

from repro.core.decompose import find_optimal_np as jax_find_np
from repro.core.decompose import make_phi_tpu
from repro.core.distribution import RowBlockDistribution as JaxRowBlock
from repro.core.distribution import matmul_domain as jax_matmul_domain
from repro.hw.tpu import chip_spec
from repro_torch.configs import get_model_config
from repro_torch.core.autotile import (
    FA_STAGES,
    FA_WGMMA_BLOCKS,
    MAX_THREADS,
    MIN_BLOCK,
    MM_MICRO,
    MM_STAGES,
    SMEM_OVERHEAD,
    WG_FRAGMENT_REGS,
    _attn_fragment_regs,
    _attn_reg_bytes,
    _attn_smem_bytes,
    _attn_threads,
    _matmul_reg_bytes,
    _matmul_smem_bytes,
    attention_path,
    matmul_path,
    matmul_tile_ok,
    plan_attention,
    plan_matmul,
    plan_matmul_horizontal,
)
from repro_torch.core.decompose import NoValidDecomposition, \
    find_optimal_np, make_phi_smem
from repro_torch.core.distribution import RowBlockDistribution, matmul_domain
from repro_torch.core.plan import PlanPolicy, Workload, plan_run
from repro_torch.hw import h100_spec
from repro_torch.models.mamba2 import (TC_CHUNKS, choose_chunk, chunk_path,
                                      ssd_workset_bytes)
from repro_torch.serve.engine import plan_decode
from repro_torch.tune.sweep import (sweep_attention, sweep_matmul,
                                    sweep_paged, sweep_ssd)

SPEC = h100_spec()
SMEM = 232_448
REG = 65536 * 4

#: Phase 5's full-width shapes (chip_smoke.py).
MM_FULL = (4096, 2048, 8192)           # llama3.2-1b MLP up, 4096 tokens
FA_FULL = (4096, 4096, 64)             # llama3.2-1b attention, 4096 tokens
SSD_FULL = (4096, 64, 64, 64)          # zamba2-1.2b mixer: S, H, P, N


@pytest.fixture(autouse=True)
def _no_tuning_artifact(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_TUNING", str(tmp_path / "absent.json"))


def _np_or_none(fn):
    try:
        return fn()
    except Exception as e:         # both packages raise their own class
        return type(e).__name__


@pytest.mark.parametrize("budget", [16 << 10, 64 << 10, SMEM, 1 << 20])
@pytest.mark.parametrize("m,k,n,el", [(4096, 2048, 8192, 2),
                                      (512, 512, 512, 4), (72, 130, 50, 4)])
def test_matmul_domain_np_matches_reference(budget, m, k, n, el):
    """Same budget, line and phi (each package's own estimator applied to
    both domains) -> same np."""
    for phi in (make_phi_tpu(sublane=16, lane=128, buffering=2),
                make_phi_smem(vec_bytes=16)):
        mine = _np_or_none(lambda: find_optimal_np(
            budget, 128, matmul_domain(m, n, k, el), 1, phi))
        ref = _np_or_none(lambda: jax_find_np(
            budget, 128, jax_matmul_domain(m, n, k, el), 1, phi))
        if mine == "NoValidDecomposition":
            assert ref == "NoValidDecomposition"
        else:
            assert mine == ref


@pytest.mark.parametrize("budget", [8 << 10, SMEM // 2, SMEM])
@pytest.mark.parametrize("kv_len,d,el", [(4096, 64, 2), (256, 64, 4),
                                         (100, 32, 4)])
def test_kv_rowblock_np_matches_reference(budget, kv_len, d, el):
    for phi in (make_phi_tpu(sublane=8, lane=128, buffering=2),
                make_phi_smem(vec_bytes=16)):
        mine = _np_or_none(lambda: find_optimal_np(
            budget, 128, [RowBlockDistribution(kv_len, d, el)] * 2, 1, phi))
        ref = _np_or_none(lambda: jax_find_np(
            budget, 128, [JaxRowBlock(kv_len, d, el)] * 2, 1, phi))
        assert mine == ref


def test_no_valid_decomposition_is_raised():
    with pytest.raises(NoValidDecomposition):
        find_optimal_np(64, 128, [RowBlockDistribution(4, 4096, 4)], 1,
                        make_phi_smem())


MM_SHAPES = [MM_FULL, (512, 512, 512), (8, 512, 8), (72, 130, 50),
             (300, 100, 200), (4096, 4096, 4096), (1, 8192, 128)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("el", [2, 4])
def test_tile_plan_fits_and_covers(m, k, n, el):
    t = plan_matmul(m, k, n, dtype_bytes=el)
    path = matmul_path(m, k, n, el)
    assert t.source == "analytic" and t.strategy == "cache_conscious"
    assert t.est_vmem_bytes == _matmul_smem_bytes(t.bm, t.bk, t.bn, el, path)
    assert t.est_vmem_bytes <= SMEM
    assert matmul_tile_ok(t.bm, t.bk, t.bn, path)
    if path == "wgmma":
        # bn/2 f32 accumulators a consumer thread (m64nN), whole 64s.
        assert t.bn // 2 <= WG_FRAGMENT_REGS
        assert t.bm % 64 == t.bk % 64 == t.bn % 64 == 0
    else:
        assert 2 * _matmul_reg_bytes(t.bm, t.bn) <= REG
        assert (t.bm // MM_MICRO) * (t.bn // MM_MICRO) <= MAX_THREADS
        for blk, dim, g in ((t.bm, m, SPEC.mma_rows),
                            (t.bn, n, SPEC.mma_rows),
                            (t.bk, k, SPEC.mma_depth(el))):
            assert blk % MIN_BLOCK == 0
            assert blk % g == 0 or dim <= g
    gi, gj, gk = t.grid
    assert gi * t.bm >= m and gj * t.bn >= n and gk * t.bk >= k
    assert (gi - 1) * t.bm < m and (gj - 1) * t.bn < n


def test_tile_level_is_shared_memory_and_page_level_unchanged():
    """The reference's _classify sends VMEM to "tile" for a matmul and to
    "page" for KV; the port's does the same with SMEM."""
    hp = plan_run(SPEC.hierarchy(), Workload(matmul=MM_FULL, dtype_bytes=2),
                  PlanPolicy(spec=SPEC))
    kinds = {lp.level: lp.kind for lp in hp.levels()}
    assert kinds == {"NVLINK": "mesh", "L2": "container", "SMEM": "tile",
                     "REG": "leaf"}
    assert hp.tile_plan() == plan_matmul(*MM_FULL)
    assert hp.page_plan() is None
    decode = plan_decode(get_model_config("llama3.2-1b"), max_len=4096,
                         batch=8, dtype_bytes=2)
    assert {lp.level: lp.kind for lp in decode.levels()}["SMEM"] == "page"
    assert decode.tile_plan() is None
    assert decode.page_plan()["page_tokens"] == 56
    assert decode.page_plan()["source"] == "analytic"
    assert decode.page_table()["pages_per_slot"] * 8 == 592


def test_horizontal_plan_is_one_slab_per_worker():
    t = plan_matmul_horizontal(1024, 256, 512, dtype_bytes=2, n_workers=4)
    assert (t.bm, t.bk, t.bn) == (256, 256, 512)
    assert t.strategy == "horizontal"
    assert t.est_vmem_bytes == _matmul_smem_bytes(256, 256, 512, 2) > SMEM


@pytest.mark.parametrize("q_len,kv_len,d", [FA_FULL, (128, 128, 64),
                                            (64, 256, 32), (100, 100, 64),
                                            (8, 512, 128), (40, 24, 16),
                                            (16384, 16384, 256)])
@pytest.mark.parametrize("el", [2, 4])
def test_attention_plan_fits(q_len, kv_len, d, el):
    p = plan_attention(q_len, kv_len, d, dtype_bytes=el)
    path = attention_path(q_len, kv_len, d, el)
    assert p.est_vmem_bytes == _attn_smem_bytes(p.block_q, p.block_kv, d, el,
                                                path) <= SMEM
    if path == "wgmma":
        assert _attn_fragment_regs(p.block_kv, d) <= WG_FRAGMENT_REGS
        assert p.block_q in FA_WGMMA_BLOCKS and p.block_kv in FA_WGMMA_BLOCKS
        assert p.block_q <= -(-q_len // 64) * 64
    else:
        assert 2 * _attn_reg_bytes(p.block_q, d) <= REG
        assert _attn_threads(p.block_q, d) <= MAX_THREADS
        assert p.block_q <= -(-q_len // 8) * 8
    assert p.block_q % MIN_BLOCK == 0 and p.block_kv % MIN_BLOCK == 0
    gq, gkv = p.grid
    assert gq * p.block_q >= q_len and gkv * p.block_kv >= kv_len


def test_full_width_sweeps_keep_the_analytic_centre():
    """Every sweep at phase 5's shapes has fitting candidates, the centre
    among them, each within one block's shared memory."""
    results = [
        sweep_matmul(*MM_FULL, dtype_bytes=2, dry=True),
        sweep_attention(*FA_FULL, dtype_bytes=2, heads=32, dry=True),
        sweep_paged(max_tokens=4096, n_kv=8, group=4, head_dim=64, slots=8,
                    dtype_bytes=2, dry=True),
        sweep_ssd(*SSD_FULL, dtype_bytes=2, dry=True),
    ]
    for r in results:
        assert r.candidates, r.kernel
        assert r.center in [c.block for c in r.candidates], r.kernel
        assert all(c.est_vmem_bytes <= r.budget_bytes == SMEM
                   for c in r.candidates)
    assert results[2].center == {"page_tokens": 56}
    assert results[3].center == {"chunk": 128}


def test_tpu_working_set_model_rejects_what_hopper_keeps():
    """The three failures of copying the TPU model with Hopper's 232,448 B:
    matmul_cc's 8 candidates, ssd_scan's 3 (the working set multiplied by
    all 64 heads) and the attention centre's resident f32 scores; and what
    the port's own models hold instead."""
    from repro.core.autotile import _attn_vmem_bytes
    from repro.models.mamba2 import ssd_workset_bytes as jax_ssd_ws
    from repro.tune.sweep import sweep_matmul as jax_sweep_matmul
    from repro.tune.sweep import sweep_ssd as jax_sweep_ssd

    tpu = chip_spec(vmem_bytes=SMEM, vmem_reserved_bytes=0)
    r = jax_sweep_matmul(*MM_FULL, dtype_bytes=2, spec=tpu, dry=True)
    assert r.center == {"bm": 128, "bk": 128, "bn": 128}
    assert (len(r.candidates), r.rejected) == (0, 8)
    r = jax_sweep_ssd(*SSD_FULL, dtype_bytes=2, spec=tpu, dry=True)
    assert (len(r.candidates), r.rejected) == (0, 3)
    assert jax_ssd_ws(64, 64, 64, 64, 2) == 6_291_456
    assert jax_ssd_ws(64, 1, 64, 64, 2) == 98_304
    assert _attn_vmem_bytes(128, 128, 64, 2) == 230_400
    # The port's models of the same blocks: SSD's one (batch, head) block
    # on the simt body, and the largest pass block of the tc body; one K
    # and one V tile on attention's simt body; on the wgmma body the Q
    # tile, two stages of K and V, and 1,152 B of alignment slack and
    # barriers.
    assert ssd_workset_bytes(128, 64, 64, "simt") == 181_760 <= SMEM
    assert ssd_workset_bytes(128, 64, 64, "tc") == 149_504 <= SMEM
    assert _attn_smem_bytes(128, 128, 64, 2) == 32_768
    assert _attn_smem_bytes(128, 128, 64, 2, "wgmma") == 83_072 <= SMEM


@pytest.mark.parametrize("seq,h,p,n", [SSD_FULL, (64, 2, 16, 16),
                                       (100, 2, 16, 8), (1 << 16, 8, 128,
                                                          128)])
def test_chunk_fits_one_block(seq, h, p, n):
    """bf16: the tc body's chunk is the largest of 64/128/256 whose largest
    pass block fits the SMEM level; shapes the tc body does not take keep
    the simt rule, the largest power of two whose one block fits."""
    c = choose_chunk(seq, h, p, n, dtype_bytes=2)
    assert c >= 64 and c & (c - 1) == 0
    path = chunk_path(2, c, p, n)
    if path == "tc":
        assert c in TC_CHUNKS
        assert ssd_workset_bytes(c, p, n) <= SMEM or c == 64
        if 2 * c in TC_CHUNKS and 2 * c <= max(64, seq):
            assert ssd_workset_bytes(2 * c, p, n) > SMEM
        return
    assert ssd_workset_bytes(c, p, n, "simt") <= SMEM or c == 64
    if c * 2 <= min(seq, 1024):
        assert ssd_workset_bytes(2 * c, p, n, "simt") > SMEM
    assert math.isclose(ssd_workset_bytes(c, p, n, "simt") / 4,
                        c * p + c * (n + 1) + c * n + 2 * c + c * c + n * p)


# ---------------------------------------------------------------------------
# The two bodies of matmul_cc and flash_attention: routing, working sets
# ---------------------------------------------------------------------------

MM_RAGGED = (4000, 2000, 8000)         # phase 5's ragged matmul
FA_RAGGED = (1000, 4000, 64)           # phase 5's ragged attention


@pytest.mark.parametrize("m,k,n,dtype,path", [
    (*MM_FULL, torch.bfloat16, "wgmma"),
    (*MM_RAGGED, torch.bfloat16, "wgmma"),
    (*MM_FULL, torch.float32, "simt"),       # no full-f32 wgmma
    (72, 130, 50, torch.bfloat16, "simt"),   # K, N not multiples of 8
    (200, 136, 264, torch.bfloat16, "wgmma"),
    (64, 130, 64, torch.bfloat16, "simt"),   # K: rows not 16-byte strides
    (64, 64, 50, torch.bfloat16, "simt"),    # N likewise
    (64, 0, 64, torch.bfloat16, "simt"),     # no K: nothing for TMA
    (*MM_FULL, 2, "wgmma"),                  # an element size works too
    (*MM_FULL, 4, "simt"),
])
def test_matmul_path_routes(m, k, n, dtype, path):
    assert matmul_path(m, k, n, dtype) == path


@pytest.mark.parametrize("q_len,kv_len,d,dtype,path", [
    (*FA_FULL, torch.bfloat16, "wgmma"),
    (*FA_RAGGED, torch.bfloat16, "wgmma"),
    (100, 300, 128, torch.bfloat16, "wgmma"),
    (*FA_FULL, torch.float32, "simt"),
    (40, 24, 16, torch.bfloat16, "simt"),    # head dims the body lacks
    (64, 256, 32, torch.bfloat16, "simt"),
    (128, 128, 256, torch.bfloat16, "simt"),
    (8, 0, 64, torch.bfloat16, "simt"),      # no keys
])
def test_attention_path_routes(q_len, kv_len, d, dtype, path):
    assert attention_path(q_len, kv_len, d, dtype) == path


def _kernel_constant(source: str, name: str) -> int:
    text = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("source,stages", [("matmul_cc.cu", MM_STAGES),
                                           ("flash_attention.cu",
                                            FA_STAGES)])
def test_wgmma_model_constants_are_the_kernels(source, stages):
    """The planner's stages and overhead are the CUDA sources' own."""
    assert _kernel_constant(source, "kStages") == stages
    assert (_kernel_constant(source, "kAlignSlack")
            + _kernel_constant(source, "kBarrierBytes")) == SMEM_OVERHEAD


@pytest.mark.parametrize("bm,bk,bn", [(64, 64, 64), (128, 64, 192),
                                      (128, 64, 256), (64, 192, 64)])
def test_wgmma_matmul_smem_is_the_kernels_formula(bm, bk, bn):
    """``wgmma_smem_bytes`` of csrc/matmul_cc.cu: four stages of the bf16
    A and B tiles, 1,024 B of alignment slack, 128 B of barriers."""
    assert _matmul_smem_bytes(bm, bk, bn, 2, "wgmma") == \
        4 * (bm * bk + bk * bn) * 2 + 1024 + 128
    assert _matmul_smem_bytes(bm, bk, bn, 2) == (bm * bk + bk * bn) * 2


@pytest.mark.parametrize("bq,bkv,d", [(64, 64, 64), (128, 128, 64),
                                      (128, 128, 128), (64, 128, 128)])
def test_wgmma_attention_smem_is_the_kernels_formula(bq, bkv, d):
    """``wgmma_smem_bytes`` of csrc/flash_attention.cu: the bf16 Q tile,
    two stages of K and V, 1,024 B of alignment slack, 128 B of
    barriers; registers: scores, output and packed P per thread."""
    assert _attn_smem_bytes(bq, bkv, d, 2, "wgmma") == \
        bq * d * 2 + 2 * 2 * bkv * d * 2 + 1024 + 128
    assert _attn_fragment_regs(bkv, d) == bkv // 2 + d // 2 + bkv // 4


@pytest.mark.parametrize("shape", [MM_FULL, MM_RAGGED])
def test_full_width_matmul_plan_takes_the_wgmma_path(shape):
    t = plan_matmul(*shape, dtype_bytes=2)
    assert matmul_path(*shape, 2) == "wgmma"
    assert t.bm % 64 == 0 and t.bn % 8 == 0 and t.bn <= 256
    assert t.bk % 64 == 0
    assert matmul_tile_ok(t.bm, t.bk, t.bn, "wgmma")
    assert t.est_vmem_bytes == _matmul_smem_bytes(t.bm, t.bk, t.bn, 2,
                                                  "wgmma") <= SMEM


@pytest.mark.parametrize("shape", [FA_FULL, FA_RAGGED])
def test_full_width_attention_plan_takes_the_wgmma_path(shape):
    p = plan_attention(*shape, dtype_bytes=2)
    assert attention_path(*shape, 2) == "wgmma"
    assert p.block_q in FA_WGMMA_BLOCKS and p.block_kv <= 256
    assert p.block_kv in FA_WGMMA_BLOCKS
    assert p.est_vmem_bytes == _attn_smem_bytes(p.block_q, p.block_kv,
                                                shape[2], 2, "wgmma")


@pytest.mark.parametrize("kernel", ["matmul_cc", "flash_attention"])
def test_full_width_sweep_candidates_obey_the_wgmma_rules(kernel):
    """Every candidate of phase 6's bf16 sweeps is a block the wgmma body
    takes, with the kernel's own shared memory."""
    if kernel == "matmul_cc":
        r = sweep_matmul(*MM_FULL, dtype_bytes=2, dry=True)
        for c in r.candidates:
            b = c.block
            assert matmul_tile_ok(b["bm"], b["bk"], b["bn"], "wgmma")
            assert c.est_vmem_bytes == _matmul_smem_bytes(
                b["bm"], b["bk"], b["bn"], 2, "wgmma")
    else:
        r = sweep_attention(*FA_FULL, dtype_bytes=2, heads=32, dry=True)
        for c in r.candidates:
            b = c.block
            assert b["block_q"] in FA_WGMMA_BLOCKS
            assert b["block_kv"] in FA_WGMMA_BLOCKS
            assert c.est_vmem_bytes == _attn_smem_bytes(
                b["block_q"], b["block_kv"], FA_FULL[2], 2, "wgmma")
    assert len(r.candidates) >= 2 and r.center in [c.block
                                                   for c in r.candidates]
