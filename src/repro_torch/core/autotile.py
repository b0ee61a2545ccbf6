"""Tile plans for the port's hand-written kernels: the counterpart of
``repro.core.autotile``, with Hopper's levels in place of VMEM.

The run-time decomposer chooses the kernels' blocks (the partitions), the
grid (the task vector) and the traversal order (the schedule):

  TCL                -> one block's shared memory (the hierarchy's SMEM
                        level), with the REG level beneath it
  phi                -> ``phi_smem``: a tile's contiguous dim in whole
                        16-byte vectors, one copy (the kernels stage each
                        tile once; Pallas double-buffers)
  np binary search   -> the same search (Algorithm 1 + §2.1.1)
  alignment          -> Hopper's granules (``hw.h100``): M/N block
                        extents in 64-row ``wgmma`` tiles, reduction
                        extents in 32-byte ``wgmma`` depth steps, 8 at
                        the least (a thread's 8 x 8 micro-tile, and
                        ``wgmma``'s N granule)
  CC / SRRC          -> the mapping from block id to output tile

Working sets.  ``_matmul_smem_bytes`` and ``_attn_smem_bytes`` count what
``csrc/matmul_cc.cu`` and ``csrc/flash_attention.cu`` put in shared memory,
byte for byte (their C functions ``*_smem_bytes`` report the same).  What
those kernels keep in registers -- the f32 accumulator of a matmul tile;
attention's query slice, accumulator and scores -- is not shared memory:
``_matmul_reg_bytes`` and ``_attn_reg_bytes`` count it, and a block fits
when it also takes at most half of the REG level (ptxas needs about as
many registers again for operands, addresses and loop state) and at most
``MAX_THREADS`` threads.  The plan field keeps the reference's name
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

#: The least block extent: a thread's 8 x 8 output micro-tile in the
#: matmul kernel, and ``wgmma``'s N granule.
MIN_BLOCK = 8

#: Threads one block may have: the kernels' ``__launch_bounds__`` (512
#: threads leave 128 registers a thread).
MAX_THREADS = 512

#: ``csrc/matmul_cc.cu``: each thread owns an 8 x 8 tile of the output.
MM_MICRO = 8

#: ``csrc/flash_attention.cu``: a row's head dim is split over threads in
#: slices of at most 32 values, and scores are taken 16 keys at a time.
FA_SLICE = 32
FA_KEY_STEP = 16


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _round_down(x: int, mult: int) -> int:
    return max(mult, (x // mult) * mult)


def _align_block(size: int, dim: int, mult: int) -> int:
    """Align a proposed block extent to a hardware multiple, clamped to the
    (rounded-up) problem dim; a dim below one multiple rounds up to
    ``MIN_BLOCK`` only."""
    if dim <= mult:
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


def _matmul_smem_bytes(bm: int, bk: int, bn: int, dtype_bytes: int) -> int:
    """Shared memory of one ``matmul_cc`` block: the A tile (bm x bk) and
    the B tile (bk x bn) in the inputs' dtype, staged once."""
    return (bm * bk + bk * bn) * dtype_bytes


def _matmul_reg_bytes(bm: int, bn: int) -> int:
    """The block's f32 accumulator, held in registers (8 x 8 a thread)."""
    return bm * bn * 4


def _matmul_regs_fit(bm: int, bn: int, regs: int) -> bool:
    threads = (bm // MM_MICRO) * (bn // MM_MICRO)
    return 2 * _matmul_reg_bytes(bm, bn) <= regs and threads <= MAX_THREADS


def _matmul_fits(bm: int, bk: int, bn: int, dtype_bytes: int, smem: int,
                 regs: int) -> bool:
    return (_matmul_smem_bytes(bm, bk, bn, dtype_bytes) <= smem
            and _matmul_regs_fit(bm, bn, regs))


def _mm_unit(dim: int, granule: int) -> int:
    return granule if dim > granule else MIN_BLOCK


def _search_matmul_tiles(m: int, k: int, n: int, dtype_bytes: int,
                         spec: "H100Spec", order: str, n_workers: int,
                         budget: int, reg_budget: int) -> MatmulTilePlan:
    """The §2.1.1 search + Hopper alignment against explicit SMEM and REG
    budgets (the planner supplies them from the hierarchy)."""
    phi = make_phi_smem(vec_bytes=spec.vec_bytes)
    domain = matmul_domain(m, n, k, element_size=dtype_bytes)
    try:
        np_ = find_optimal_np(budget, spec.smem_line_bytes, domain,
                              n_workers, phi)
    except NoValidDecomposition:
        np_ = max(1, n_workers)      # a dim below one tile: one block

    mn_g, k_g = spec.mma_rows, spec.mma_depth(dtype_bytes)
    side = max(1, round(math.isqrt(np_)))
    bm = _align_block(math.ceil(m / side), m, mn_g)
    bk = _align_block(math.ceil(k / side), k, k_g)
    bn = _align_block(math.ceil(n / side), n, mn_g)

    # Shrink to fit after alignment: registers bound bm x bn, shared
    # memory all three; halve the largest extent that helps, never below
    # one granule.
    units = {"m": _mm_unit(m, mn_g), "k": _mm_unit(k, k_g),
             "n": _mm_unit(n, mn_g)}
    while not _matmul_fits(bm, bk, bn, dtype_bytes, budget, reg_budget):
        ext = {"m": bm, "k": bk, "n": bn}
        names = (("m", "k", "n") if _matmul_regs_fit(bm, bn, reg_budget)
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
        est_vmem_bytes=_matmul_smem_bytes(bm, bk, bn, dtype_bytes),
        strategy="cache_conscious")


def plan_matmul(m: int, k: int, n: int, dtype_bytes: int = 2,
                spec: Optional["H100Spec"] = None, order: str = "cc",
                n_workers: int = 1) -> MatmulTilePlan:
    """Cache-conscious matmul tile plan: a single-card ``plan_run`` over
    the card's hierarchy, returning the SMEM level's tile plan (the same
    search the planner runs there, so the two agree by construction)."""
    from repro_torch.core.plan import PlanPolicy, Workload, plan_run

    spec = _spec_or_default(spec)
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
    multiples of 8, clamped to the rounded-up problem dims, the block's
    shared memory and registers within budget -- so a stale or foreign
    entry cannot give a plan the analytic path could not.  Returns
    ``(plan, tuning_detail)``; the detail is None when the analytic choice
    stands.
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

    def cap(v: int, dim: int, granule: int) -> int:
        return min(v, _round_up(dim, _mm_unit(dim, granule)))

    bm = cap(ext[0], tile.m, spec.mma_rows)
    bk = cap(ext[1], tile.k, spec.mma_depth(dtype_bytes))
    bn = cap(ext[2], tile.n, spec.mma_rows)
    if not _matmul_fits(bm, bk, bn, dtype_bytes, budget, reg_budget):
        return tile, None
    tuned = dataclasses.replace(
        tile, bm=bm, bk=bk, bn=bn,
        est_vmem_bytes=_matmul_smem_bytes(bm, bk, bn, dtype_bytes),
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
    """Threads that share one query row (each holds ``FA_SLICE`` dims)."""
    return max(1, head_dim // FA_SLICE)


def _attn_smem_bytes(block_kv: int, head_dim: int, dtype_bytes: int) -> int:
    """Shared memory of one ``flash_attention`` block: the K and V tiles
    (block_kv x head_dim each) in the inputs' dtype, staged once."""
    return 2 * block_kv * head_dim * dtype_bytes


def _attn_reg_bytes(block_q: int, head_dim: int) -> int:
    """What one block keeps in registers, f32: each row's query and
    accumulator (head_dim each), and 16 scores in each thread of the row."""
    return block_q * (2 * head_dim + FA_KEY_STEP * _attn_group(head_dim)) * 4


def _attn_threads(block_q: int, head_dim: int) -> int:
    return _round_up(block_q * _attn_group(head_dim), 32)


def _attn_regs_fit(block_q: int, head_dim: int, regs: int) -> bool:
    return (2 * _attn_reg_bytes(block_q, head_dim) <= regs
            and _attn_threads(block_q, head_dim) <= MAX_THREADS)


def _attn_fits(block_q: int, block_kv: int, head_dim: int,
               dtype_bytes: int, smem: int, regs: int) -> bool:
    return (_attn_smem_bytes(block_kv, head_dim, dtype_bytes) <= smem
            and _attn_regs_fit(block_q, head_dim, regs))


def plan_attention(q_len: int, kv_len: int, head_dim: int,
                   dtype_bytes: int = 2, spec: Optional["H100Spec"] = None,
                   use_tuned: bool = True) -> AttentionTilePlan:
    """Decompose the KV sequence so one K and one V partition fit a
    block's shared memory -- the paper's decomposition with the KV stream
    as the domain.  The query side lives in registers on Hopper, so it
    takes none of the shared-memory budget (the TPU plan reserved half of
    VMEM for it); ``block_q`` is then the largest aligned extent whose
    registers fit the REG level.

    With ``use_tuned`` a matching measured winner from the port's tuning
    artifact overrides the analytic blocks (precedence analytic < tuned)
    after re-passing the same fit; any miss leaves the analytic choice.
    """
    spec = _spec_or_default(spec)
    budget, regs = _budgets(spec)
    q_g, kv_g = spec.mma_rows, spec.mma_depth(dtype_bytes)
    phi = make_phi_smem(vec_bytes=spec.vec_bytes)

    # Stage 1 (paper search): partition K and V (kv_len x d row blocks).
    kv_domain = [RowBlockDistribution(kv_len, head_dim, dtype_bytes),   # K
                 RowBlockDistribution(kv_len, head_dim, dtype_bytes)]   # V
    try:
        np_ = find_optimal_np(budget, spec.smem_line_bytes, kv_domain, 1,
                              phi)
    except NoValidDecomposition:
        np_ = 1
    block_kv = _align_block(math.ceil(kv_len / np_), kv_len, kv_g)

    # Stage 2: the largest aligned block_q whose registers fit.
    bq = _round_up(min(q_len, 2048), MIN_BLOCK)
    while bq > MIN_BLOCK and not _attn_regs_fit(bq, head_dim, regs):
        bq = _round_down(bq // 2, q_g if bq // 2 >= q_g else MIN_BLOCK)
    while (_attn_smem_bytes(block_kv, head_dim, dtype_bytes) > budget
           and block_kv > kv_g):
        block_kv = _round_down(block_kv // 2, kv_g)

    bq = min(bq, _round_up(q_len, MIN_BLOCK))
    plan = AttentionTilePlan(
        q_len=q_len, kv_len=kv_len, head_dim=head_dim, block_q=bq,
        block_kv=block_kv, np=np_,
        est_vmem_bytes=_attn_smem_bytes(block_kv, head_dim, dtype_bytes))
    if use_tuned:
        plan = _apply_tuned_attention(plan, dtype_bytes, spec, budget, regs)
    return plan


def _apply_tuned_attention(plan: AttentionTilePlan, dtype_bytes: int,
                           spec: "H100Spec", budget: int,
                           regs: int) -> AttentionTilePlan:
    """Replace the analytic blocks with a matching sweep winner, keeping
    the invariants the analytic path keeps (multiples of 8, clamped to the
    rounded-up sequence, shared memory and registers within budget)."""
    from repro_torch.tune.cache import bucket_attention, lookup_tuned

    entry = lookup_tuned(
        "flash_attention", spec.name,
        bucket_attention(plan.q_len, plan.kv_len, plan.head_dim,
                         dtype_bytes))
    if entry is None:
        return plan
    block = entry.get("block", {})
    bq_t, bkv_t = block.get("block_q"), block.get("block_kv")
    if not (isinstance(bq_t, int) and isinstance(bkv_t, int)
            and bq_t >= MIN_BLOCK and bkv_t >= MIN_BLOCK
            and bq_t % MIN_BLOCK == 0 and bkv_t % MIN_BLOCK == 0):
        return plan
    bq_t = min(bq_t, _round_up(plan.q_len, MIN_BLOCK))
    bkv_t = min(bkv_t, _round_up(plan.kv_len, MIN_BLOCK))
    if not _attn_fits(bq_t, bkv_t, plan.head_dim, dtype_bytes, budget,
                      regs):
        return plan
    return dataclasses.replace(
        plan, block_q=bq_t, block_kv=bkv_t,
        est_vmem_bytes=_attn_smem_bytes(bkv_t, plan.head_dim, dtype_bytes),
        source="tuned")


def clamp_attention_plan(plan: AttentionTilePlan, q_len: int, kv_len: int,
                         dtype_bytes: int = 2) -> AttentionTilePlan:
    """The effective plan ``flash_attention`` runs: blocks shrunk to the
    actual sequence (``max(8, min(block, seq))``).  When the clamp changes
    the choice, ``source`` gains a ``+clamped`` suffix, so sweeps and logs
    name the block that ran, never the diverged paper choice."""
    bq = max(MIN_BLOCK, min(plan.block_q, q_len))
    bkv = max(MIN_BLOCK, min(plan.block_kv, kv_len))
    if (bq, bkv) == (plan.block_q, plan.block_kv):
        return plan
    return dataclasses.replace(
        plan, block_q=bq, block_kv=bkv,
        est_vmem_bytes=_attn_smem_bytes(bkv, plan.head_dim, dtype_bytes),
        source=plan.source + "+clamped")
