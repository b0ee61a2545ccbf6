"""Empirical neighbourhood sweep around the port planner's analytic tiles
(the counterpart of ``repro.tune.sweep``).

For each kernel the analytic block is the centre of a small neighbourhood
-- half and double each extent, re-aligned to the granules of the body
the shape takes (``matmul_path``/``attention_path``), matmul's doubled
extent capped at the wgmma body's largest -- every candidate is filtered
through the working-set model the planner uses, which counts what that
body puts in one block's shared memory (``core.autotile``'s
``_matmul_smem_bytes``/``_attn_smem_bytes``, with the REG-level check of
what it keeps in registers; ``models.mamba2.ssd_workset_bytes`` of the
body each chunk runs on; the paged kernel's staging at each page,
``kernels.paged_attention.smem_bytes``, beside the page level's own
two-buffered-pages rule), the survivors are timed, and
the winner is persisted to the port's tuning artifact (``tune.cache``) for
the planner to consult.

Timing (``time_callable``): on a card, CUDA events around each of
``iters`` warmed-up calls, read after one ``synchronize``; on the CPU a
host clock.  Each sweep takes ``device=`` (``None`` means the card).
``dry=True`` stops after enumeration and filtering, and touches no device.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.autotile import (
    WG_MAX_CONSUMERS,
    WG_MAX_N,
    WG_ROWS,
    _align_block,
    _attn_fits,
    _attn_granule,
    _attn_smem_bytes,
    _budgets,
    _matmul_fits,
    _matmul_smem_bytes,
    _mm_granules,
    _mm_unit,
    _round_down,
    _round_up,
    _search_matmul_tiles,
    attention_path,
    clamp_attention_plan,
    matmul_path,
    plan_attention,
)
from repro_torch.hw.h100 import H100Spec, h100_spec
from repro_torch.tune.cache import (
    TuningEntry,
    bucket_attention,
    bucket_matmul,
    bucket_paged,
    bucket_ssd,
    hw_fingerprint,
    record_tuned,
)

__all__ = [
    "Candidate",
    "SweepResult",
    "SWEEPS",
    "default_sweeps",
    "run_sweeps",
    "sweep_attention",
    "sweep_matmul",
    "sweep_paged",
    "sweep_ssd",
    "time_callable",
]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def time_callable(fn: Callable[[], Any], warmup: int = 2, iters: int = 5,
                  device=None) -> float:
    """Median seconds of ``fn()`` after ``warmup`` discarded calls.  On a
    card each call sits between two CUDA events and the events are read
    after one ``synchronize`` (PyTorch returns before the card finishes,
    so a host clock would time the enqueue); on the CPU a host clock."""
    dev = resolve_device(device)
    for _ in range(max(0, warmup)):
        fn()
    n = max(1, iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for start, end in marks:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(dev)
        times = [start.elapsed_time(end) / 1e3 for start, end in marks]
    else:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass
class Candidate:
    """One swept block assignment: the extents, the block's shared memory
    under the planner's model, and (after timing) the measured median."""

    block: Dict[str, int]
    est_vmem_bytes: int
    fits: bool
    median_us: Optional[float] = None

    @property
    def label(self) -> str:
        return "/".join(f"{k}={v}" for k, v in sorted(self.block.items()))


@dataclass
class SweepResult:
    kernel: str
    bucket: str
    workload: Dict[str, Any]
    budget_bytes: int
    center: Dict[str, int]
    candidates: List[Candidate] = field(default_factory=list)  # fit only
    rejected: int = 0            # enumerated but over a budget
    entry: Optional[TuningEntry] = None      # None on a dry run

    @property
    def winner(self) -> Optional[Candidate]:
        timed = [c for c in self.candidates if c.median_us is not None]
        return min(timed, key=lambda c: c.median_us) if timed else None

    @property
    def analytic_us(self) -> Optional[float]:
        for c in self.candidates:
            if c.block == self.center and c.median_us is not None:
                return c.median_us
        return None


def _finish(result: SweepResult, spec: H100Spec, dry: bool,
            make_fn: Callable[[Candidate], Callable[[], Any]],
            warmup: int, iters: int, workload: Mapping[str, Any],
            device) -> SweepResult:
    """Time every fitting candidate and fold the winner into an entry."""
    if dry:
        return result
    for cand in result.candidates:
        fn = make_fn(cand)
        cand.median_us = time_callable(fn, warmup=warmup, iters=iters,
                                       device=device) * 1e6
    win = result.winner
    analytic_us = result.analytic_us
    if win is None or analytic_us is None:
        return result
    result.entry = TuningEntry(
        kernel=result.kernel,
        arch=spec.name,
        bucket=result.bucket,
        fingerprint=hw_fingerprint(device),
        block=dict(win.block),
        analytic_block=dict(result.center),
        median_us=round(win.median_us, 3),
        analytic_us=round(analytic_us, 3),
        speedup=round(analytic_us / max(win.median_us, 1e-9), 4),
        workload=dict(workload),
    )
    return result


def _dedup_fitting(raw: List[Dict[str, int]], est: Callable[[Mapping], int],
                   fits: Callable[[Mapping], bool]
                   ) -> Tuple[List[Candidate], int]:
    seen, fitting, rejected = set(), [], 0
    for block in raw:
        key = tuple(sorted(block.items()))
        if key in seen:
            continue
        seen.add(key)
        if fits(block):
            fitting.append(Candidate(block=block, est_vmem_bytes=est(block),
                                     fits=True))
        else:
            rejected += 1
    return fitting, rejected


def _dtype_of(dtype_bytes: int) -> torch.dtype:
    return {2: torch.bfloat16, 4: torch.float32}.get(dtype_bytes,
                                                     torch.float32)


def _randn(gen: torch.Generator, shape, dtype, dev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# ---------------------------------------------------------------------------
# matmul_cc
# ---------------------------------------------------------------------------


def _extent_options(center: int, dim: int, granule: int, path: str,
                    cap: Optional[int] = None) -> List[int]:
    """Half and double one block extent, re-aligned to the granule the
    analytic search uses on ``path``, clamped to the rounded-up problem
    dim and to ``cap``, the body's largest extent (so a centre between
    half the cap and the cap still tries the cap)."""
    unit = _mm_unit(dim, granule, path)
    double = _align_block(center * 2, dim, granule, path)
    opts = {center, _round_down(center // 2, unit),
            double if cap is None else max(center, min(double, cap))}
    return sorted(o for o in opts if o >= 1)


def sweep_matmul(m: int, k: int, n: int, dtype_bytes: int = 2,
                 spec: Optional[H100Spec] = None, order: str = "cc",
                 warmup: int = 1, iters: int = 5, dry: bool = False,
                 device=None) -> SweepResult:
    spec = spec or h100_spec()
    budget, regs = _budgets(spec)
    center = _search_matmul_tiles(m, k, n, dtype_bytes, spec, order, 1,
                                  budget, regs)
    path = matmul_path(m, k, n, dtype_bytes)
    mn_g, k_g = _mm_granules(path, dtype_bytes, spec)
    caps = (WG_MAX_CONSUMERS * WG_ROWS, WG_MAX_N, WG_MAX_N) \
        if path == "wgmma" else (None, None, None)
    raw = [{"bm": bm, "bk": bk, "bn": bn}
           for bm in _extent_options(center.bm, m, mn_g, path, caps[0])
           for bk in _extent_options(center.bk, k, k_g, path, caps[1])
           for bn in _extent_options(center.bn, n, mn_g, path, caps[2])]
    fitting, rejected = _dedup_fitting(
        raw,
        lambda b: _matmul_smem_bytes(b["bm"], b["bk"], b["bn"], dtype_bytes,
                                     path),
        lambda b: _matmul_fits(b["bm"], b["bk"], b["bn"], dtype_bytes,
                               budget, regs, path))
    result = SweepResult(
        kernel="matmul_cc",
        bucket=bucket_matmul(m, k, n, dtype_bytes),
        workload={"m": m, "k": k, "n": n, "dtype_bytes": dtype_bytes},
        budget_bytes=budget,
        center={"bm": center.bm, "bk": center.bk, "bn": center.bn},
        candidates=fitting, rejected=rejected,
    )
    if dry:
        return result

    from repro_torch.kernels.matmul_cc import matmul_cc

    dev = resolve_device(device)
    dt = _dtype_of(dtype_bytes)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = _randn(gen, (m, k), dt, dev)
    b = _randn(gen, (k, n), dt, dev)

    def make_fn(cand: Candidate):
        plan = dataclasses.replace(
            center, bm=cand.block["bm"], bk=cand.block["bk"],
            bn=cand.block["bn"], est_vmem_bytes=cand.est_vmem_bytes)
        return lambda: matmul_cc(a, b, plan=plan)

    return _finish(result, spec, dry, make_fn, warmup, iters,
                   result.workload, dev)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def sweep_attention(q_len: int, kv_len: int, head_dim: int,
                    dtype_bytes: int = 2, heads: int = 4, batch: int = 1,
                    causal: bool = True, spec: Optional[H100Spec] = None,
                    warmup: int = 1, iters: int = 5, dry: bool = False,
                    device=None) -> SweepResult:
    spec = spec or h100_spec()
    budget, regs = _budgets(spec)
    analytic = plan_attention(q_len, kv_len, head_dim,
                              dtype_bytes=dtype_bytes, spec=spec,
                              use_tuned=False)
    # Sweep the blocks the kernel runs (the wrapper clamps a block larger
    # than the sequence), re-aligned to the body's granule: candidates
    # must be admissible as tuned entries.
    path = attention_path(q_len, kv_len, head_dim, dtype_bytes)
    g = _attn_granule(path)
    clamped = clamp_attention_plan(analytic, q_len, kv_len,
                                   dtype_bytes=dtype_bytes)
    center = dataclasses.replace(
        clamped,
        block_q=min(_round_up(clamped.block_q, g), _round_up(q_len, g)),
        block_kv=min(_round_up(clamped.block_kv, g), _round_up(kv_len, g)))

    def opts(c: int, length: int) -> List[int]:
        o = {c, max(g, _round_down(c // 2, g)),
             min(_round_up(c * 2, g), _round_up(length, g))}
        return sorted(x for x in o if x >= g)

    raw = [{"block_q": bq, "block_kv": bkv}
           for bq in opts(center.block_q, q_len)
           for bkv in opts(center.block_kv, kv_len)]
    fitting, rejected = _dedup_fitting(
        raw,
        lambda b: _attn_smem_bytes(b["block_q"], b["block_kv"], head_dim,
                                   dtype_bytes, path),
        lambda b: _attn_fits(b["block_q"], b["block_kv"], head_dim,
                             dtype_bytes, budget, regs, path))
    result = SweepResult(
        kernel="flash_attention",
        bucket=bucket_attention(q_len, kv_len, head_dim, dtype_bytes),
        workload={"q_len": q_len, "kv_len": kv_len, "head_dim": head_dim,
                  "dtype_bytes": dtype_bytes, "heads": heads,
                  "batch": batch, "causal": causal},
        budget_bytes=budget,
        center={"block_q": center.block_q, "block_kv": center.block_kv},
        candidates=fitting, rejected=rejected,
    )
    if dry:
        return result

    from repro_torch.kernels.flash_attention import flash_attention

    dev = resolve_device(device)
    dt = _dtype_of(dtype_bytes)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (batch, heads, q_len, head_dim), dt, dev)
    k = _randn(gen, (batch, heads, kv_len, head_dim), dt, dev)
    v = _randn(gen, (batch, heads, kv_len, head_dim), dt, dev)

    def make_fn(cand: Candidate):
        plan = dataclasses.replace(
            center, block_q=cand.block["block_q"],
            block_kv=cand.block["block_kv"],
            est_vmem_bytes=cand.est_vmem_bytes)
        return lambda: flash_attention(q, k, v, causal=causal, plan=plan)

    return _finish(result, spec, dry, make_fn, warmup, iters,
                   result.workload, dev)


# ---------------------------------------------------------------------------
# paged_attention (the plan's page level)
# ---------------------------------------------------------------------------


def sweep_paged(max_tokens: int = 256, n_kv: int = 2, group: int = 2,
                head_dim: int = 32, slots: int = 4, dtype_bytes: int = 4,
                spec: Optional[H100Spec] = None, warmup: int = 1,
                iters: int = 5, dry: bool = False,
                device=None) -> SweepResult:
    """Sweep the decode page size: the candidates perturb the plan's
    ``page_tokens`` and each re-lays the pool at that granule.  A candidate
    is admitted by the page level's own rule (two buffered pages within
    the level, as ``_tuned_page_tokens`` re-checks) and by the kernel's
    shared memory at that page, for the body the page runs on (the split
    body stages two pages of one KV head, so its staging follows the
    page)."""
    from repro_torch.core.plan import (PAGE_ALIGN, PAGE_BUFFERING,
                                       PlanPolicy, Workload, plan_run)
    from repro_torch.kernels.paged_attention import paged_path, smem_bytes

    spec = spec or h100_spec()
    budget, _ = _budgets(spec)
    tok_bytes = 2 * n_kv * head_dim * dtype_bytes      # K + V, one layer
    hp = plan_run(
        spec.hierarchy(),
        Workload(kv_bytes_per_token=tok_bytes, kv_layers=1, kv_heads=n_kv,
                 max_tokens=max_tokens),
        PlanPolicy(spec=spec, use_tuned=False))
    center_pt = int(hp.page_plan()["page_tokens"])
    cap = _round_up(max_tokens, PAGE_ALIGN)
    raw_pts = {center_pt,
               max(PAGE_ALIGN, _round_down(center_pt // 2, PAGE_ALIGN)),
               min(cap, _round_up(center_pt * 2, PAGE_ALIGN))}
    dt = _dtype_of(dtype_bytes)

    def staged(b):
        pt = b["page_tokens"]
        return smem_bytes(group, head_dim, pt,
                          paged_path(dt, head_dim, pt, group))

    fitting, rejected = _dedup_fitting(
        [{"page_tokens": pt} for pt in sorted(raw_pts)],
        staged,
        lambda b: (PAGE_BUFFERING * b["page_tokens"] * tok_bytes <= budget
                   and staged(b) <= budget))
    result = SweepResult(
        kernel="paged_attention",
        bucket=bucket_paged(tok_bytes, max_tokens),
        workload={"max_tokens": max_tokens, "n_kv": n_kv, "group": group,
                  "head_dim": head_dim, "slots": slots,
                  "dtype_bytes": dtype_bytes, "tok_bytes": tok_bytes},
        budget_bytes=budget,
        center={"page_tokens": center_pt},
        candidates=fitting, rejected=rejected,
    )
    if dry:
        return result

    from repro_torch.kernels.paged_attention import paged_attention

    dev = resolve_device(device)
    h = n_kv * group
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (slots, h, head_dim), dt, dev)
    lengths = torch.randint(max_tokens // 2, max_tokens + 1, (slots,),
                            generator=gen, device=dev, dtype=torch.int32)

    def make_fn(cand: Candidate):
        pt = cand.block["page_tokens"]
        n_logical = -(-max_tokens // pt)
        p_total = 1 + slots * n_logical          # + reserved null page
        k_pages = _randn(gen, (p_total, pt, n_kv, head_dim), dt, dev)
        v_pages = _randn(gen, (p_total, pt, n_kv, head_dim), dt, dev)
        table = (1 + torch.randperm(slots * n_logical, generator=gen,
                                    device=dev)).reshape(
            slots, n_logical).to(torch.int32)
        return lambda: paged_attention(q, k_pages, v_pages, table, lengths,
                                       page_tokens=pt)

    return _finish(result, spec, dry, make_fn, warmup, iters,
                   result.workload, dev)


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------


def sweep_ssd(seq_len: int = 256, n_heads: int = 2, head_dim: int = 32,
              state_dim: int = 32, dtype_bytes: int = 4, batch: int = 1,
              spec: Optional[H100Spec] = None, warmup: int = 1,
              iters: int = 5, dry: bool = False,
              device=None) -> SweepResult:
    from repro_torch.models.mamba2 import (choose_chunk, chunk_path,
                                           ssd_workset_bytes)

    spec = spec or h100_spec()
    budget, _ = _budgets(spec)                # choose_chunk's own budget
    center_c = choose_chunk(seq_len, n_heads, head_dim, state_dim,
                            dtype_bytes=dtype_bytes, spec=spec,
                            use_tuned=False)
    cap = min(_round_up(seq_len, 8), 1024)
    raw_cs = {center_c, max(16, _round_down(center_c // 2, 8)),
              min(cap, _round_up(center_c * 2, 8))}

    def est(b):
        c = b["chunk"]
        return ssd_workset_bytes(
            c, head_dim, state_dim,
            chunk_path(dtype_bytes, c, head_dim, state_dim))

    fitting, rejected = _dedup_fitting(
        [{"chunk": c} for c in sorted(raw_cs)], est,
        lambda b: est(b) <= budget)
    result = SweepResult(
        kernel="ssd_scan",
        bucket=bucket_ssd(seq_len, n_heads, head_dim, state_dim,
                          dtype_bytes),
        workload={"seq_len": seq_len, "n_heads": n_heads,
                  "head_dim": head_dim, "state_dim": state_dim,
                  "dtype_bytes": dtype_bytes, "batch": batch},
        budget_bytes=budget,
        center={"chunk": center_c},
        candidates=fitting, rejected=rejected,
    )
    if dry:
        return result

    from repro_torch.kernels.ssd_scan import ssd_scan

    dev = resolve_device(device)
    dt = _dtype_of(dtype_bytes)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (batch, seq_len, n_heads, head_dim), dt, dev)
    dts = (torch.nn.functional.softplus(
        torch.randn((batch, seq_len, n_heads), generator=gen, device=dev))
        * 0.5).to(dt)
    A = -torch.exp(torch.randn((n_heads,), generator=gen, device=dev) * 0.3)
    Bm = _randn(gen, (batch, seq_len, state_dim), dt, dev)
    Cm = _randn(gen, (batch, seq_len, state_dim), dt, dev)

    def make_fn(cand: Candidate):
        c = cand.block["chunk"]
        return lambda: ssd_scan(x, dts, A, Bm, Cm, chunk=c)

    return _finish(result, spec, dry, make_fn, warmup, iters,
                   result.workload, dev)


# ---------------------------------------------------------------------------
# Orchestration (python -m repro_torch.launch.tune drives this)
# ---------------------------------------------------------------------------

#: Kernel name -> sweep function; the order is the report order.
SWEEPS = {
    "matmul_cc": sweep_matmul,
    "flash_attention": sweep_attention,
    "paged_attention": sweep_paged,
    "ssd_scan": sweep_ssd,
}


def default_sweeps(quick: bool = False) -> Dict[str, Dict[str, Any]]:
    """The stock sweep workloads, the JAX package's own (small, float32).
    Buckets are power-of-two, so these cover every shape in the same
    bucket; ``chip_smoke.py`` sweeps the full-width shapes itself."""
    if quick:
        return {
            "matmul_cc": {"m": 256, "k": 256, "n": 256, "dtype_bytes": 4},
            "flash_attention": {"q_len": 128, "kv_len": 128, "head_dim": 64,
                                "dtype_bytes": 4},
            "paged_attention": {"max_tokens": 64, "n_kv": 2, "group": 2,
                                "head_dim": 16, "slots": 2,
                                "dtype_bytes": 4},
            "ssd_scan": {"seq_len": 128, "n_heads": 2, "head_dim": 16,
                         "state_dim": 16, "dtype_bytes": 4},
        }
    return {
        "matmul_cc": {"m": 512, "k": 512, "n": 512, "dtype_bytes": 4},
        "flash_attention": {"q_len": 256, "kv_len": 256, "head_dim": 64,
                            "dtype_bytes": 4},
        "paged_attention": {"max_tokens": 256, "n_kv": 2, "group": 2,
                            "head_dim": 32, "slots": 4, "dtype_bytes": 4},
        "ssd_scan": {"seq_len": 256, "n_heads": 2, "head_dim": 32,
                     "state_dim": 32, "dtype_bytes": 4},
    }


def run_sweeps(kernels: Optional[Sequence[str]] = None,
               quick: bool = False, dry: bool = False,
               warmup: int = 1, iters: int = 5,
               spec: Optional[H100Spec] = None,
               out_path: Optional[str] = None,
               write: bool = True, device=None) -> List[SweepResult]:
    """Run the stock sweeps and (unless ``dry`` or ``write=False``) merge
    the winners into the port's tuning artifact."""
    workloads = default_sweeps(quick)
    names = list(kernels) if kernels else list(SWEEPS)
    results = []
    for name in names:
        if name not in SWEEPS:
            raise KeyError(f"unknown kernel {name!r}; known: {list(SWEEPS)}")
        kw = dict(workloads[name])
        kw.update(dry=dry, warmup=warmup, iters=iters, device=device)
        if spec is not None:
            kw["spec"] = spec
        results.append(SWEEPS[name](**kw))
    if not dry and write:
        entries = [r.entry for r in results if r.entry is not None]
        if entries:
            record_tuned(entries, path=out_path)
    return results
