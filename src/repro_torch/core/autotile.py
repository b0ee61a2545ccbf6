"""Tile plans for the port's hand-written kernels: the counterpart of
``repro.core.autotile``, with Hopper's levels in place of VMEM.

The run-time decomposer chooses the kernels' blocks (the partitions), the
grid (the task vector) and the traversal order (the schedule):

  TCL                -> one block's shared memory (the hierarchy's SMEM
                        level), with the REG level beneath it
  phi                -> ``phi_smem``: a tile's contiguous dim in whole
                        16-byte vectors, times the copies the kernel keeps
                        (its ring of stages; Pallas double-buffers)
  np binary search   -> the same search (Algorithm 1 + §2.1.1)
  alignment          -> Hopper's granules, per kernel body (below)
  CC / SRRC          -> the mapping from block id to output tile

Two bodies per kernel.  ``matmul_path`` and ``attention_path`` say which
body of ``csrc/matmul_cc.cu`` / ``csrc/flash_attention.cu`` runs a shape,
and every working-set and fit function takes that path:

  ``wgmma``  bf16 on the tensor cores, fed by TMA.  Block extents are
             whole 64s: bm and block_q are 64 rows per consumer warpgroup
             (at most two), bn and bk (and block_kv) whole 128-byte
             swizzle atoms of 64 bf16 values, bn and bk at most 256 (one
             wgmma's N; one TMA box).  Shared memory holds a ring of
             ``MM_STAGES`` (``FA_STAGES``) stages plus ``SMEM_OVERHEAD``;
             registers hold, per consumer thread, the wgmma fragments.
  ``simt``   float32 (and bf16 shapes TMA cannot describe) on the CUDA
             cores: M/N extents in 64-row tiles, reduction extents in
             32-byte depth steps, 8 at the least (a thread's 8 x 8
             micro-tile); one copy of each tile in shared memory.

Working sets.  ``_matmul_smem_bytes`` and ``_attn_smem_bytes`` count what
the kernels put in shared memory, byte for byte (their C functions
``*_smem_bytes`` report the same).  What those kernels keep in registers
is not shared memory: ``_matmul_regs_fit`` and ``_attn_regs_fit`` check it
against the REG level.  The plan field keeps the reference's name
``est_vmem_bytes`` so that readers find the counterpart; on Hopper it
holds the block's shared-memory bytes.

Left for later: ``plan_matmul_cached`` (callers use ``core.plan.
leaf_matmul_plan``) and the ``vmem_fraction`` knob, which no caller of the
port sets.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Tuple

from repro_torch.core.decompose import (NoValidDecomposition,
                                        find_optimal_np, make_phi_smem)
from repro_torch.core.distribution import RowBlockDistribution, matmul_domain

if TYPE_CHECKING:       # hw.h100 imports core, which imports this module
    from repro_torch.hw.h100 import H100Spec

#: The least block extent of the simt bodies: a thread's 8 x 8 output
#: micro-tile in the matmul kernel.
MIN_BLOCK = 8

#: Threads one simt block may have: the kernels' ``__launch_bounds__``
#: (512 threads leave 128 registers a thread).
MAX_THREADS = 512

#: ``csrc/matmul_cc.cu`` simt body: each thread owns an 8 x 8 tile of the
#: output.
MM_MICRO = 8

#: ``csrc/flash_attention.cu`` simt body: a row's head dim is split over
#: threads in slices of at most 32 values, and scores are taken 16 keys at
#: a time.
FA_SLICE = 32
FA_KEY_STEP = 16

#: The wgmma bodies.  One consumer warpgroup runs m64 products over 64
#: rows; a block has at most two.
WG_ROWS = 64
WG_MAX_CONSUMERS = 2
#: bf16 values in one 128-byte swizzled row: the granule of bk, bn and
#: block_kv (TMA boxes and wgmma operands are whole atoms).
WG_ATOM = 64
#: One wgmma's largest N, and TMA's largest box edge.
WG_MAX_N = 256
#: Stages of the shared-memory ring: ``kStages`` of each source.
MM_STAGES = 4
FA_STAGES = 2
#: Shared memory beyond the stages: 1,024 bytes of slack to align the
#: tiles for the 128-byte swizzle, and 128 bytes of mbarriers.
SMEM_OVERHEAD = 1024 + 128
#: Registers a thread has after ``setmaxnreg``: the producer warpgroup
#: keeps 40, each consumer thread takes 232 (128 x 40 + 256 x 232 <=
#: 65,536, the SM's file).
WG_PRODUCER_REGS = 40
WG_CONSUMER_REGS = 232
#: What the wgmma fragments of one consumer thread may take: its
#: registers less 64 for addresses, descriptors, loop and softmax state.
WG_FRAGMENT_REGS = WG_CONSUMER_REGS - 64
#: Head dims the attention wgmma body takes, and the block_q and
#: block_kv it is built for: all that the fragment registers admit at
#: those head dims (``_attn_regs_fit``).
FA_WGMMA_HEAD_DIMS = (64, 128)
FA_WGMMA_BLOCKS = (64, 128)


def _itemsize(dtype) -> int:
    """Bytes of one element: a torch dtype's ``itemsize``, or the int."""
    return int(getattr(dtype, "itemsize", dtype))


def matmul_path(m: int, k: int, n: int, dtype) -> str:
    """The body of ``csrc/matmul_cc.cu`` that runs ``(m, k) @ (k, n)``:
    ``"wgmma"`` for bf16 operands whose rows TMA can describe (row strides
    of K and N elements are whole 16-byte units: K and N multiples of 8),
    else ``"simt"`` (float32, where wgmma has no full-f32 product and TF32
    would miss the 1e-4 tolerance; ragged bf16 rows).  ``dtype`` is a
    torch dtype or an element size; 2 bytes means bf16, the port's only
    2-byte type."""
    del m
    if _itemsize(dtype) == 2 and k > 0 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


def attention_path(q_len: int, kv_len: int, head_dim: int, dtype) -> str:
    """The body of ``csrc/flash_attention.cu`` that runs a shape:
    ``"wgmma"`` for bf16 at head dims 64 and 128 (whole 128-byte rows for
    TMA, m64n64/n128 for P V), else ``"simt"``."""
    if (_itemsize(dtype) == 2 and head_dim in FA_WGMMA_HEAD_DIMS
            and q_len > 0 and kv_len > 0):
        return "wgmma"
    return "simt"


def _wg_block_regs(consumers: int) -> int:
    """Registers of one wgmma block after ``setmaxnreg``."""
    return 128 * (WG_PRODUCER_REGS + consumers * WG_CONSUMER_REGS)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _round_down(x: int, mult: int) -> int:
    return max(mult, (x // mult) * mult)


def _align_block(size: int, dim: int, mult: int, path: str = "simt") -> int:
    """Align a proposed block extent to a hardware multiple, clamped to the
    (rounded-up) problem dim.  On the simt path a dim below one multiple
    rounds up to ``MIN_BLOCK`` only; the wgmma path never goes below one
    multiple (TMA zero-fills the rest of the box)."""
    if dim <= mult and path == "simt":
        return _round_up(dim, MIN_BLOCK)
    return min(_round_up(size, mult), _round_up(dim, mult))


def _spec_or_default(spec: Optional["H100Spec"]) -> "H100Spec":
    from repro_torch.hw.h100 import h100_spec

    return spec or h100_spec()


def _budgets(spec: "H100Spec") -> Tuple[int, int]:
    """(shared-memory bytes of one block, register bytes of one SM)."""
    h = spec.hierarchy()
    return h.find("SMEM").per_core_size(), h.find("REG").per_core_size()


# ---------------------------------------------------------------------------
# Matmul tile planning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MatmulTilePlan:
    """Blocked C[m,n] = A[m,k] @ B[k,n] plan for ``kernels.matmul_cc``."""

    m: int
    k: int
    n: int
    bm: int
    bk: int
    bn: int
    order: str                  # "cc" | "srrc"
    np: int                     # the paper-search partition count
    est_vmem_bytes: int         # shared memory of one block (see above)
    strategy: str               # "cache_conscious" | "horizontal"
    source: str = "analytic"    # "analytic" | "tuned"

    @property
    def grid(self) -> Tuple[int, int, int]:
        # (i over M, j over N, kk over K); the kernel loops over kk.
        return (math.ceil(self.m / self.bm), math.ceil(self.n / self.bn),
                math.ceil(self.k / self.bk))

    @property
    def n_tasks(self) -> int:
        gi, gj, gk = self.grid
        return gi * gj * gk


def _matmul_smem_bytes(bm: int, bk: int, bn: int, dtype_bytes: int,
                       path: str = "simt") -> int:
    """Shared memory of one ``matmul_cc`` block.  wgmma: ``MM_STAGES``
    stages of the A tile (bm x bk) and the B tile (bk x bn) in bf16, plus
    alignment slack and barriers; simt: one A and one B tile in the
    inputs' dtype."""
    stage = (bm * bk + bk * bn) * dtype_bytes
    if path == "wgmma":
        return MM_STAGES * stage + SMEM_OVERHEAD
    return stage


def _matmul_reg_bytes(bm: int, bn: int) -> int:
    """The block's f32 accumulator, held in registers."""
    return bm * bn * 4


def matmul_tile_ok(bm: int, bk: int, bn: int, path: str) -> bool:
    """The tile shapes a body of ``csrc/matmul_cc.cu`` takes.  wgmma: bm
    64 or 128 (one consumer warpgroup per 64 rows), bk and bn whole
    64-value swizzle atoms, at most 256 (a TMA box edge; one wgmma's N);
    simt: bm and bn multiples of 8 (the micro-tile)."""
    if path == "wgmma":
        return (bm % WG_ROWS == 0 and 0 < bm <= WG_MAX_CONSUMERS * WG_ROWS
                and bk % WG_ATOM == 0 and 0 < bk <= WG_MAX_N
                and bn % WG_ATOM == 0 and 0 < bn <= WG_MAX_N)
    return bm % MM_MICRO == 0 and bn % MM_MICRO == 0 and bm > 0 \
        and bn > 0 and bk >= 1


def _matmul_regs_fit(bm: int, bn: int, regs: int,
                     path: str = "simt") -> bool:
    """wgmma: each consumer thread holds bn/2 f32 accumulators (m64nN),
    within its fragment registers, and the block's registers after
    ``setmaxnreg`` fit the REG level; simt: the accumulator takes at most
    half the REG level, over at most ``MAX_THREADS`` threads."""
    if path == "wgmma":
        consumers = -(-bm // WG_ROWS)
        return (bn // 2 <= WG_FRAGMENT_REGS
                and 4 * _wg_block_regs(consumers) <= regs)
    threads = (bm // MM_MICRO) * (bn // MM_MICRO)
    return 2 * _matmul_reg_bytes(bm, bn) <= regs and threads <= MAX_THREADS


def _matmul_fits(bm: int, bk: int, bn: int, dtype_bytes: int, smem: int,
                 regs: int, path: str = "simt") -> bool:
    return (matmul_tile_ok(bm, bk, bn, path)
            and _matmul_smem_bytes(bm, bk, bn, dtype_bytes, path) <= smem
            and _matmul_regs_fit(bm, bn, regs, path))


def _mm_granules(path: str, dtype_bytes: int,
                 spec: "H100Spec") -> Tuple[int, int]:
    """(M/N granule, K granule) of a body: whole 64s on the wgmma path;
    ``wgmma``'s tile rows and depth on the simt path."""
    if path == "wgmma":
        return WG_ATOM, WG_ATOM
    return spec.mma_rows, spec.mma_depth(dtype_bytes)


def _mm_unit(dim: int, granule: int, path: str = "simt") -> int:
    return granule if dim > granule or path == "wgmma" else MIN_BLOCK


def _search_matmul_tiles(m: int, k: int, n: int, dtype_bytes: int,
                         spec: "H100Spec", order: str, n_workers: int,
                         budget: int, reg_budget: int,
                         path: Optional[str] = None) -> MatmulTilePlan:
    """The §2.1.1 search + Hopper alignment against explicit SMEM and REG
    budgets (the planner supplies them from the hierarchy), for the body
    ``matmul_path`` picks, or for ``path``."""
    path = path or matmul_path(m, k, n, dtype_bytes)
    phi = make_phi_smem(vec_bytes=spec.vec_bytes,
                        buffering=MM_STAGES if path == "wgmma" else 1)
    domain = matmul_domain(m, n, k, element_size=dtype_bytes)
    try:
        np_ = find_optimal_np(budget, spec.smem_line_bytes, domain,
                              n_workers, phi)
    except NoValidDecomposition:
        np_ = max(1, n_workers)      # a dim below one tile: one block

    mn_g, k_g = _mm_granules(path, dtype_bytes, spec)
    side = max(1, round(math.isqrt(np_)))
    bm = _align_block(math.ceil(m / side), m, mn_g, path)
    bk = _align_block(math.ceil(k / side), k, k_g, path)
    bn = _align_block(math.ceil(n / side), n, mn_g, path)
    if path == "wgmma":              # the body's largest tile
        bm = min(bm, WG_MAX_CONSUMERS * WG_ROWS)
        bk, bn = min(bk, WG_MAX_N), min(bn, WG_MAX_N)

    # Shrink to fit after alignment: registers bound bm x bn, shared
    # memory all three; halve the largest extent that helps, never below
    # one granule.
    units = {"m": _mm_unit(m, mn_g, path), "k": _mm_unit(k, k_g, path),
             "n": _mm_unit(n, mn_g, path)}
    while not _matmul_fits(bm, bk, bn, dtype_bytes, budget, reg_budget,
                           path):
        ext = {"m": bm, "k": bk, "n": bn}
        names = (("m", "k", "n") if _matmul_regs_fit(bm, bn, reg_budget,
                                                     path)
                 else ("m", "n"))
        shrinkable = [w for w in names if ext[w] > units[w]]
        if not shrinkable:
            break                    # the kernel wrapper refuses it
        which = max(shrinkable, key=lambda w: ext[w])
        new = _round_down(ext[which] // 2, units[which])
        if which == "m":
            bm = new
        elif which == "k":
            bk = new
        else:
            bn = new

    return MatmulTilePlan(
        m=m, k=k, n=n, bm=bm, bk=bk, bn=bn, order=order, np=np_,
        est_vmem_bytes=_matmul_smem_bytes(bm, bk, bn, dtype_bytes, path),
        strategy="cache_conscious")


def plan_matmul(m: int, k: int, n: int, dtype_bytes: int = 2,
                spec: Optional["H100Spec"] = None, order: str = "cc",
                n_workers: int = 1,
                path: Optional[str] = None) -> MatmulTilePlan:
    """Cache-conscious matmul tile plan: a single-card ``plan_run`` over
    the card's hierarchy, returning the SMEM level's tile plan (the same
    search the planner runs there, so the two agree by construction).
    ``path`` plans for that body instead of ``matmul_path``'s, with the
    same search against the same budgets (and no tuning artifact, which
    is the routed body's)."""
    from repro_torch.core.plan import PlanPolicy, Workload, plan_run

    spec = _spec_or_default(spec)
    if path is not None:
        budget, regs = _budgets(spec)
        return _search_matmul_tiles(m, k, n, dtype_bytes, spec, order,
                                    n_workers, budget, regs, path)
    hp = plan_run(spec.hierarchy(),
                  Workload(matmul=(m, k, n), dtype_bytes=dtype_bytes),
                  PlanPolicy(order=order, n_workers=n_workers, spec=spec))
    return hp.tile_plan()


def apply_tuned_matmul(tile: MatmulTilePlan, dtype_bytes: int,
                       spec: "H100Spec", budget: int, reg_budget: int
                       ) -> Tuple[MatmulTilePlan, Optional[dict]]:
    """Replace an analytic tile plan's extents with a matching sweep winner
    from the port's tuning artifact (precedence analytic < tuned).

    The tuned extents re-pass the invariants the analytic search keeps --
    the body's tile shapes (``matmul_tile_ok``), clamped to the rounded-up
    problem dims, the block's shared memory and registers within budget
    -- so a stale or foreign entry cannot give a plan the analytic path
    could not.  Returns ``(plan, tuning_detail)``; the detail is None when
    the analytic choice stands.
    """
    from repro_torch.tune.cache import bucket_matmul, lookup_tuned

    entry = lookup_tuned("matmul_cc", spec.name,
                         bucket_matmul(tile.m, tile.k, tile.n, dtype_bytes))
    if entry is None:
        return tile, None
    block = entry.get("block", {})
    ext = [block.get(x) for x in ("bm", "bk", "bn")]
    if not all(isinstance(v, int) and v >= MIN_BLOCK and v % MIN_BLOCK == 0
               for v in ext):
        return tile, None

    path = matmul_path(tile.m, tile.k, tile.n, dtype_bytes)
    mn_g, k_g = _mm_granules(path, dtype_bytes, spec)

    def cap(v: int, dim: int, granule: int) -> int:
        return min(v, _round_up(dim, _mm_unit(dim, granule, path)))

    bm = cap(ext[0], tile.m, mn_g)
    bk = cap(ext[1], tile.k, k_g)
    bn = cap(ext[2], tile.n, mn_g)
    if not _matmul_fits(bm, bk, bn, dtype_bytes, budget, reg_budget, path):
        return tile, None
    tuned = dataclasses.replace(
        tile, bm=bm, bk=bk, bn=bn,
        est_vmem_bytes=_matmul_smem_bytes(bm, bk, bn, dtype_bytes, path),
        source="tuned")
    return tuned, _tuning_detail(entry)


def _tuning_detail(entry: dict) -> dict:
    return {
        "speedup": entry.get("speedup", 1.0),
        "median_us": entry.get("median_us", 0.0),
        "analytic_us": entry.get("analytic_us", 0.0),
        "analytic_block": entry.get("analytic_block", {}),
        "fingerprint": entry.get("fingerprint", ""),
    }


def plan_matmul_horizontal(m: int, k: int, n: int, dtype_bytes: int = 2,
                           n_workers: int = 1) -> MatmulTilePlan:
    """The paper's horizontal baseline: one row slab per worker, no cache
    sizing (its working set usually exceeds shared memory)."""
    bm = math.ceil(m / max(1, n_workers))
    return MatmulTilePlan(
        m=m, k=k, n=n, bm=bm, bk=k, bn=n, order="cc",
        np=max(1, n_workers),
        est_vmem_bytes=_matmul_smem_bytes(bm, k, n, dtype_bytes),
        strategy="horizontal")


# ---------------------------------------------------------------------------
# Attention tile planning (flash-style streaming over the KV sequence)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionTilePlan:
    q_len: int
    kv_len: int
    head_dim: int
    block_q: int
    block_kv: int
    np: int
    est_vmem_bytes: int         # shared memory of one block (see above)
    source: str = "analytic"    # "analytic" | "tuned", "+clamped" suffix
                                # when the kernel shrank a block

    @property
    def grid(self) -> Tuple[int, int]:
        return (math.ceil(self.q_len / self.block_q),
                math.ceil(self.kv_len / self.block_kv))


def _attn_group(head_dim: int) -> int:
    """Threads that share one query row in the simt body (each holds
    ``FA_SLICE`` dims)."""
    return max(1, head_dim // FA_SLICE)


def _attn_smem_bytes(block_q: int, block_kv: int, head_dim: int,
                     dtype_bytes: int, path: str = "simt") -> int:
    """Shared memory of one ``flash_attention`` block.  wgmma: the Q tile
    (block_q x head_dim) and ``FA_STAGES`` stages of the K and V tiles
    (block_kv x head_dim each) in bf16, plus alignment slack and
    barriers; simt: one K and one V tile in the inputs' dtype (Q lives in
    registers)."""
    kv = 2 * block_kv * head_dim * dtype_bytes
    if path == "wgmma":
        return (block_q * head_dim * dtype_bytes + FA_STAGES * kv
                + SMEM_OVERHEAD)
    return kv


def _attn_fragment_regs(block_kv: int, head_dim: int) -> int:
    """32-bit registers of one wgmma consumer thread's fragments: the
    f32 scores (block_kv/2), the f32 output (head_dim/2) and the bf16
    probabilities packed in pairs (block_kv/4)."""
    return block_kv // 2 + head_dim // 2 + block_kv // 4


def _attn_reg_bytes(block_q: int, head_dim: int) -> int:
    """What one simt block keeps in registers, f32: each row's query and
    accumulator (head_dim each), and 16 scores in each thread of the row."""
    return block_q * (2 * head_dim + FA_KEY_STEP * _attn_group(head_dim)) * 4


def _attn_threads(block_q: int, head_dim: int) -> int:
    return _round_up(block_q * _attn_group(head_dim), 32)


def attention_blocks_ok(block_q: int, block_kv: int, path: str) -> bool:
    """The blocks a body of ``csrc/flash_attention.cu`` takes.  wgmma:
    block_q 64 or 128 (one consumer warpgroup per 64 rows), block_kv whole
    64-row tiles up to one wgmma's N (256); simt: multiples of 8."""
    if path == "wgmma":
        return (block_q % WG_ROWS == 0
                and 0 < block_q <= WG_MAX_CONSUMERS * WG_ROWS
                and block_kv % WG_ATOM == 0 and 0 < block_kv <= WG_MAX_N)
    return block_q >= 1 and block_kv >= 1


def _attn_regs_fit(block_q: int, block_kv: int, head_dim: int, regs: int,
                   path: str = "simt") -> bool:
    """wgmma: a consumer thread's fragments within its fragment
    registers, the block's registers after ``setmaxnreg`` within the REG
    level; simt: at most half the REG level over at most ``MAX_THREADS``
    threads."""
    if path == "wgmma":
        return (_attn_fragment_regs(block_kv, head_dim) <= WG_FRAGMENT_REGS
                and 4 * _wg_block_regs(-(-block_q // WG_ROWS)) <= regs)
    return (2 * _attn_reg_bytes(block_q, head_dim) <= regs
            and _attn_threads(block_q, head_dim) <= MAX_THREADS)


def _attn_fits(block_q: int, block_kv: int, head_dim: int,
               dtype_bytes: int, smem: int, regs: int,
               path: str = "simt") -> bool:
    return (attention_blocks_ok(block_q, block_kv, path)
            and _attn_smem_bytes(block_q, block_kv, head_dim, dtype_bytes,
                                 path) <= smem
            and _attn_regs_fit(block_q, block_kv, head_dim, regs, path))


def _attn_granule(path: str) -> int:
    """The least step of block_q and block_kv."""
    return WG_ATOM if path == "wgmma" else MIN_BLOCK


def plan_attention(q_len: int, kv_len: int, head_dim: int,
                   dtype_bytes: int = 2, spec: Optional["H100Spec"] = None,
                   use_tuned: bool = True,
                   path: Optional[str] = None) -> AttentionTilePlan:
    """Decompose the KV sequence so the K and V partitions, times the
    copies the kernel keeps, fit a block's shared memory -- the paper's
    decomposition with the KV stream as the domain.  Then the blocks the
    body (``attention_path``) takes: on the wgmma path block_kv at most
    one wgmma's N and within the fragment registers, block_q 64 rows per
    consumer warpgroup; on the simt path the query side lives in
    registers, so it takes none of the shared-memory budget (the TPU plan
    reserved half of VMEM for it), and ``block_q`` is the largest aligned
    extent whose registers fit the REG level.  Both then shrink until the
    block fits.

    With ``use_tuned`` a matching measured winner from the port's tuning
    artifact overrides the analytic blocks (precedence analytic < tuned)
    after re-passing the same fit; any miss leaves the analytic choice.
    ``path`` plans for that body instead of ``attention_path``'s (the
    tuning artifact is the routed body's, so it is not consulted).
    """
    spec = _spec_or_default(spec)
    budget, regs = _budgets(spec)
    if path is not None:
        use_tuned = False
    path = path or attention_path(q_len, kv_len, head_dim, dtype_bytes)
    wgmma = path == "wgmma"
    phi = make_phi_smem(vec_bytes=spec.vec_bytes,
                        buffering=FA_STAGES if wgmma else 1)

    # Stage 1 (paper search): partition K and V (kv_len x d row blocks).
    kv_domain = [RowBlockDistribution(kv_len, head_dim, dtype_bytes),   # K
                 RowBlockDistribution(kv_len, head_dim, dtype_bytes)]   # V
    try:
        np_ = find_optimal_np(budget, spec.smem_line_bytes, kv_domain, 1,
                              phi)
    except NoValidDecomposition:
        np_ = 1

    def fits(bq: int, bkv: int) -> bool:
        return _attn_fits(bq, bkv, head_dim, dtype_bytes, budget, regs,
                          path)

    if wgmma:
        g = _attn_granule(path)
        bkv = min(_align_block(math.ceil(kv_len / np_), kv_len, g, path),
                  WG_MAX_N)
        bq = min(_round_up(q_len, g), WG_MAX_CONSUMERS * WG_ROWS)
        # Shrink block_kv first (registers and shared memory both), then
        # block_q.
        while not fits(bq, bkv) and bkv > g:
            bkv = _round_down(bkv // 2, g)
        while not fits(bq, bkv) and bq > g:
            bq = _round_down(bq // 2, g)
    else:
        q_g, kv_g = spec.mma_rows, spec.mma_depth(dtype_bytes)
        bkv = _align_block(math.ceil(kv_len / np_), kv_len, kv_g)
        # Stage 2: the largest aligned block_q whose registers fit.
        bq = _round_up(min(q_len, 2048), MIN_BLOCK)
        while bq > MIN_BLOCK and not _attn_regs_fit(bq, bkv, head_dim,
                                                    regs):
            bq = _round_down(bq // 2, q_g if bq // 2 >= q_g else MIN_BLOCK)
        while (_attn_smem_bytes(bq, bkv, head_dim, dtype_bytes) > budget
               and bkv > kv_g):
            bkv = _round_down(bkv // 2, kv_g)
        bq = min(bq, _round_up(q_len, MIN_BLOCK))
    plan = AttentionTilePlan(
        q_len=q_len, kv_len=kv_len, head_dim=head_dim, block_q=bq,
        block_kv=bkv, np=np_,
        est_vmem_bytes=_attn_smem_bytes(bq, bkv, head_dim, dtype_bytes,
                                        path))
    if use_tuned:
        plan = _apply_tuned_attention(plan, dtype_bytes, spec, budget, regs)
    return plan


def _apply_tuned_attention(plan: AttentionTilePlan, dtype_bytes: int,
                           spec: "H100Spec", budget: int,
                           regs: int) -> AttentionTilePlan:
    """Replace the analytic blocks with a matching sweep winner, keeping
    the invariants the analytic path keeps (the body's granule, clamped to
    the rounded-up sequence, shared memory and registers within budget)."""
    from repro_torch.tune.cache import bucket_attention, lookup_tuned

    entry = lookup_tuned(
        "flash_attention", spec.name,
        bucket_attention(plan.q_len, plan.kv_len, plan.head_dim,
                         dtype_bytes))
    if entry is None:
        return plan
    path = attention_path(plan.q_len, plan.kv_len, plan.head_dim,
                          dtype_bytes)
    g = _attn_granule(path)
    block = entry.get("block", {})
    bq_t, bkv_t = block.get("block_q"), block.get("block_kv")
    if not (isinstance(bq_t, int) and isinstance(bkv_t, int)
            and bq_t >= g and bkv_t >= g and bq_t % g == 0
            and bkv_t % g == 0):
        return plan
    bq_t = min(bq_t, _round_up(plan.q_len, g))
    bkv_t = min(bkv_t, _round_up(plan.kv_len, g))
    if not _attn_fits(bq_t, bkv_t, plan.head_dim, dtype_bytes, budget,
                      regs, path):
        return plan
    return dataclasses.replace(
        plan, block_q=bq_t, block_kv=bkv_t,
        est_vmem_bytes=_attn_smem_bytes(bq_t, bkv_t, plan.head_dim,
                                        dtype_bytes, path),
        source="tuned")


def clamp_attention_plan(plan: AttentionTilePlan, q_len: int, kv_len: int,
                         dtype_bytes: int = 2,
                         path: Optional[str] = None) -> AttentionTilePlan:
    """The effective plan ``flash_attention`` runs: blocks shrunk to the
    actual sequence -- ``max(8, min(block, seq))`` on the simt path, the
    sequence rounded up to whole 64s on the wgmma path (TMA zero-fills the
    rest of a box).  When the clamp changes the choice, ``source`` gains a
    ``+clamped`` suffix, so sweeps and logs name the block that ran, never
    the diverged paper choice.  ``path`` defaults to
    ``attention_path``'s."""
    path = path or attention_path(q_len, kv_len, plan.head_dim, dtype_bytes)
    if path == "wgmma":
        bq = max(WG_ROWS, min(plan.block_q, _round_up(q_len, WG_ROWS)))
        bkv = max(WG_ATOM, min(plan.block_kv, _round_up(kv_len, WG_ATOM)))
    else:
        bq = max(MIN_BLOCK, min(plan.block_q, q_len))
        bkv = max(MIN_BLOCK, min(plan.block_kv, kv_len))
    if (bq, bkv) == (plan.block_q, plan.block_kv):
        return plan
    return dataclasses.replace(
        plan, block_q=bq, block_kv=bkv,
        est_vmem_bytes=_attn_smem_bytes(bq, bkv, plan.head_dim, dtype_bytes,
                                        path),
        source=plan.source + "+clamped")
