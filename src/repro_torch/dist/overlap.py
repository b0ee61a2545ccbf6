"""Ring collective matmuls: stream mesh-level partitions while computing
(the port of ``repro.dist.overlap``).

The paper's CC/SRRC schedules keep one partition resident while the next is
being fetched from the level above.  At the mesh level the "level above" is
the interconnect: these kernels decompose the contraction into one
partition per card and overlap the point-to-point transfer of the next
partition (``torch.distributed.batch_isend_irecv`` on the ring axis's
process group) with the block product of the current one: step s+1's send
and receive are issued before step s's product and waited after it.

Two streaming orders, chosen by the scheduler (``RingPlan``/``plan_ring``,
over the port's ``core.schedule.ring_stream_order``):

  * ``ring``       -- CC order: one direction, the whole chunk hops
    forward each step.
  * ``serpentine`` -- SRRC order: both directions at once, each carrying
    half of every chunk.

The kernels (``make_ag_matmul``, ``make_ag_matmul_fused``,
``make_rs_matmul``) take DTensors (or plain tensors, read as replicated)
and give DTensors: each input is redistributed to the reference's
``in_specs``, its local shard runs the ring, and the result is wrapped
with the reference's ``out_specs``.  The ring itself is a
``torch.autograd.Function`` whose backward is written out, where JAX
derives it from ``shard_map`` + ``ppermute``:

  * all-gather ``y = x @ w`` (x k-sharded, w n-sharded): dx is a
    reduce-scatter ring of ``dy @ w_band^T``; dw re-streams x around the
    ring, each chunk's ``chunk^T @ dy`` landing in its row band;
  * reduce-scatter ``y = x @ w`` (x and w k-sharded, y m-sharded): one
    all-gather stream of dy gives dx's row blocks (``dy_blk @ w^T``) and dw
    (``x_rows^T @ dy_blk``).

Every block product, forward and backward, runs under ``torch.no_grad()``
through ``_block_matmul``: on a CUDA tensor the hand-written ``matmul_cc``
kernel under the memoized SMEM leaf of the planner
(``core.plan.leaf_matmul_plan``) -- a card-level cache-conscious plan inside
every mesh-level ring step, the paper's hierarchy recursion -- and
``torch.matmul`` on a CPU tensor.  ``overlap_matmul`` is the dispatch
``models.layers.tp_matmul`` calls; ``cluster.disagg.transfer_order`` reads
``plan_ring`` to order a prompt's KV pages between replicas.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.core.schedule import ring_stream_order
from repro_torch.dist.sharding import (P, _axis_sizes, active_overlap,
                                       contiguous_stride, placements)
from repro_torch.roofline.ops import book_collective

#: Collective modes the ring plan understands.
MODES = ("ring", "serpentine")


@dataclass(frozen=True)
class RingPlan:
    """Plan-time schedule of one ring collective: the per-step
    chunk-owner offsets chosen by the scheduler and the permutation lists
    (source rank -> destination rank) built once here.  ``bwd_*`` fields
    are None in single-direction ("ring") mode."""

    p: int
    mode: str                                   # "ring" | "serpentine"
    fwd_offsets: Tuple[int, ...]                # step s consumes (rank - off)
    fwd_perm: Tuple[Tuple[int, int], ...]       # i -> i+1 ring shift
    bwd_offsets: Optional[Tuple[int, ...]] = None
    bwd_perm: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def bidirectional(self) -> bool:
        return self.bwd_perm is not None

    def describe(self) -> list:
        """One printable line per ring step showing the permutation(s) the
        step issues."""

        def fmt(perm):
            return " ".join(f"{a}>{b}" for a, b in perm)

        lines = []
        for s in range(self.p):
            fwd = f"fwd:src=rank-{self.fwd_offsets[s]}"
            if s < self.p - 1:
                fwd += f";ppermute={fmt(self.fwd_perm)}"
            else:
                fwd += ";last_step=no_permute"
            if not self.bidirectional:
                lines.append(fwd)
                continue
            hops_back = (self.p - self.bwd_offsets[s]) % self.p
            bwd = f"bwd:src=rank+{hops_back}"
            if s < self.p - 1:
                bwd += f";ppermute={fmt(self.bwd_perm)}"
            else:
                bwd += ";last_step=no_permute"
            lines.append(f"{fwd}|{bwd}")
        return lines


@lru_cache(maxsize=64)
def plan_ring(p: int, mode: str = "ring") -> RingPlan:
    """The plan-time schedule for a ``p``-way ring: "ring" takes the CC
    order (one direction), "serpentine" the SRRC order (both directions,
    half of every chunk each).  Permutation lists are built once here."""
    if mode not in MODES:
        raise ValueError(f"unknown collectives mode {mode!r}; one of {MODES}")
    order = ring_stream_order(p, "cc" if mode == "ring" else "srrc")
    fwd = tuple(step[0] for step in order)
    fwd_perm = tuple((i, (i + 1) % p) for i in range(p))
    if mode == "ring":
        return RingPlan(p=p, mode=mode, fwd_offsets=fwd, fwd_perm=fwd_perm)
    bwd = tuple(step[1] for step in order)
    bwd_perm = tuple((i, (i - 1) % p) for i in range(p))
    # A physical ring shifts chunks one hop per step: the scheduler's order
    # must be realizable before anything trusts it.
    if not (all((fwd[s + 1] - fwd[s]) % p == 1 for s in range(p - 1))
            and all((bwd[s + 1] - bwd[s]) % p == p - 1
                    for s in range(p - 1))):
        raise ValueError(f"ring order not one hop a step: {fwd} / {bwd}")
    return RingPlan(p=p, mode=mode, fwd_offsets=fwd, fwd_perm=fwd_perm,
                    bwd_offsets=bwd, bwd_perm=bwd_perm)


# ---------------------------------------------------------------------------
# Per-step block compute (the card-level decomposer nested in the mesh step)
# ---------------------------------------------------------------------------


def _block_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One ring step's block product: ``matmul_cc`` under the planner's
    SMEM leaf on a CUDA tensor, ``torch.matmul`` on a CPU tensor.  There is
    no other route: a CUDA failure raises."""
    if a.device.type == "cuda":
        from repro_torch.core.plan import leaf_matmul_plan
        from repro_torch.kernels.matmul_cc import matmul_cc

        a, b = a.contiguous(), b.contiguous()
        plan = leaf_matmul_plan(a.shape[0], a.shape[1], b.shape[1],
                                dtype_bytes=a.element_size())
        return matmul_cc(a, b, plan=plan)
    return torch.matmul(a, b)


def _check_div(name: str, dim: int, n: int, over: str = "ring axis") -> None:
    if dim % n != 0:
        raise ValueError(
            f"{name}={dim} must divide evenly over the {n}-way {over}")


def _lead_spec(batch_axes: Tuple[str, ...]):
    if not batch_axes:
        return None
    return batch_axes[0] if len(batch_axes) == 1 else tuple(batch_axes)


def _batch_extent(mesh, batch_axes: Tuple[str, ...]) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in batch_axes) if batch_axes else 1


# ---------------------------------------------------------------------------
# The ring: transport and the four streams
# ---------------------------------------------------------------------------


class _Ring:
    """One rank's view of a ``p``-way ring on mesh axis ``axis``: its
    position, its peers in each direction (global ranks), and the streams
    the kernels and their backwards are made of."""

    def __init__(self, mesh, axis: str, mode: str):
        self.p = _axis_sizes(mesh)[axis]
        self.plan = plan_ring(self.p, mode)
        self.mesh, self.axis = mesh, axis
        self.idx = mesh.get_local_rank(axis)
        group = mesh.get_group(axis)

        def peers(perm):
            dst = dict(perm)[self.idx]
            src = {b: a for a, b in perm}[self.idx]
            return (dist.get_global_rank(group, dst),
                    dist.get_global_rank(group, src))
        self.fwd = peers(self.plan.fwd_perm)
        self.bwd = peers(self.plan.bwd_perm) if self.plan.bidirectional \
            else None

    def _shift(self, fwd: torch.Tensor, bwd: Optional[torch.Tensor] = None):
        """Start sending ``fwd`` one hop forward (and ``bwd`` one hop
        backward) and receiving their successors; returns the requests, the
        receive buffers and the send buffers (held until the wait)."""
        ops, bufs, sent = [], [], []
        group = self.mesh.get_group(self.axis)   # the live world's group
        for tag, (t, (dst, src)) in enumerate(
                [(fwd, self.fwd)] + ([(bwd, self.bwd)] if bwd is not None
                                     else [])):
            t = t.contiguous()
            sent.append(t)
            book_collective("collective-permute",
                            t.numel() * t.element_size())
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, dst, group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, src, group, tag))
            bufs.append(buf)
        return dist.batch_isend_irecv(ops), bufs, sent

    def gather_stream(self, chunk: torch.Tensor, split: int,
                      consume: Callable) -> None:
        """Stream every rank's ``chunk`` past this one.  Ring mode: at step
        s this rank holds the chunk of rank ``(idx - off_s) mod p`` and
        calls ``consume(part, src, lo, hi)`` on it whole (``lo, hi`` the
        column range of ``chunk`` along dim ``split``).  Serpentine: the
        chunk is halved along ``split``; the low half streams forward and
        the high half backward, each consumed with its own owner."""
        plan, p, idx = self.plan, self.p, self.idx
        width = chunk.shape[split]
        if not plan.bidirectional:
            cur = chunk
            for s, off in enumerate(plan.fwd_offsets):
                pending = self._shift(cur) if s < p - 1 else None
                consume(cur, (idx - off) % p, 0, width)
                if pending is not None:
                    for r in pending[0]:
                        r.wait()
                    cur = pending[1][0]
            return
        half = width // 2
        lo, hi = chunk.narrow(split, 0, half), \
            chunk.narrow(split, half, width - half)
        for s in range(p):
            pending = self._shift(lo, hi) if s < p - 1 else None
            consume(lo, (idx - plan.fwd_offsets[s]) % p, 0, half)
            consume(hi, (idx - plan.bwd_offsets[s]) % p, half, width)
            if pending is not None:
                for r in pending[0]:
                    r.wait()
                lo, hi = pending[1]

    def reduce_stream(self, partial: Callable, width: int) -> torch.Tensor:
        """Reduce-scatter over the ring: ``partial(r, lo, hi)`` is this
        rank's contribution to output block ``r``, columns ``[lo, hi)`` of
        ``width``; returns this rank's block, summed over every rank.
        Ring mode: block ``(idx + p-1 - off_s) mod p``'s accumulator rides
        forward.  Serpentine: the low columns ride forward, the high ones
        backward.  The next step's partial is computed while the
        accumulator is on the wire."""
        plan, p, idx = self.plan, self.p, self.idx
        if not plan.bidirectional:
            acc = None
            for s, off in enumerate(plan.fwd_offsets):
                part = partial((idx + (p - 1) - off) % p, 0, width)
                if acc is not None:
                    for r in acc[0]:
                        r.wait()
                    part = acc[1][0] + part
                if s == p - 1:
                    return part
                acc = self._shift(part)
        half = width // 2
        acc = None
        for s in range(p):
            s_b = (p - plan.bwd_offsets[s]) % p
            pf = partial((idx + (p - 1) - plan.fwd_offsets[s]) % p, 0, half)
            pb = partial((idx - (p - 1) + s_b) % p, half, width)
            if acc is not None:
                for r in acc[0]:
                    r.wait()
                pf, pb = acc[1][0] + pf, acc[1][1] + pb
            if s == p - 1:
                return torch.cat([pf, pb], dim=1)
            acc = self._shift(pf, pb)


@lru_cache(maxsize=64)
def _ring(mesh, axis: str, mode: str) -> _Ring:
    return _Ring(mesh, axis, mode)


class _AgRing(torch.autograd.Function):
    """``ys[i] = x_full @ ws[i]`` on local shards: ``x`` ``(m, k/p)`` this
    rank's k-chunk, each ``w`` ``(k, n_i/p)`` this rank's columns."""

    @staticmethod
    def forward(ctx, ring: _Ring, x: torch.Tensor, *ws: torch.Tensor):
        ctx.ring = ring
        ctx.save_for_backward(x, *ws)
        kb = x.shape[1]
        accs = [torch.zeros(x.shape[0], w.shape[1], device=x.device,
                            dtype=torch.promote_types(x.dtype, w.dtype))
                for w in ws]

        def consume(part, src, lo, hi):
            for acc, w in zip(accs, ws):
                acc += _block_matmul(part, w[src * kb + lo:src * kb + hi])
        with torch.no_grad():
            ring.gather_stream(x, 1, consume)
        return tuple(accs)

    @staticmethod
    def backward(ctx, *dys):
        ring = ctx.ring
        x, *ws = ctx.saved_tensors
        kb = x.shape[1]
        dys = [torch.zeros(x.shape[0], w.shape[1], dtype=x.dtype,
                           device=x.device) if dy is None
               else dy.to(x.dtype).contiguous() for dy, w in zip(dys, ws)]
        with torch.no_grad():
            dx = None
            if ctx.needs_input_grad[1]:
                def partial(r, lo, hi):
                    out = None
                    for dy, w in zip(dys, ws):
                        band = w[r * kb + lo:r * kb + hi].t()
                        y = _block_matmul(dy, band)
                        out = y if out is None else out + y
                    return out
                dx = ring.reduce_stream(partial, kb)
            dws = [torch.zeros_like(w) for w in ws]

            def consume(part, src, lo, hi):
                pt = part.t()
                for dw, dy in zip(dws, dys):
                    dw[src * kb + lo:src * kb + hi] += _block_matmul(pt, dy)
            if any(ctx.needs_input_grad[2:]):
                ring.gather_stream(x, 1, consume)
        return (None, dx, *dws)


class _RsRing(torch.autograd.Function):
    """``y = x_full @ w_full`` reduce-scattered over rows: ``x`` ``(m,
    k/p)`` and ``w`` ``(k/p, n)`` this rank's shards, ``y`` ``(m/p, n)``
    this rank's row block."""

    @staticmethod
    def forward(ctx, ring: _Ring, x: torch.Tensor, w: torch.Tensor):
        ctx.ring = ring
        ctx.save_for_backward(x, w)
        mb = x.shape[0] // ring.p
        dtype = torch.promote_types(x.dtype, w.dtype)

        def partial(r, lo, hi):
            return _block_matmul(x[r * mb:(r + 1) * mb],
                                 w[:, lo:hi]).to(dtype)
        with torch.no_grad():
            return ring.reduce_stream(partial, w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        ring = ctx.ring
        x, w = ctx.saved_tensors
        mb = x.shape[0] // ring.p
        dy = dy.to(x.dtype).contiguous()
        with torch.no_grad():
            dx = torch.zeros_like(x)
            dw = torch.zeros_like(w)

            def consume(part, src, lo, hi):
                rows = slice(src * mb, (src + 1) * mb)
                dx[rows] += _block_matmul(part, w[:, lo:hi].t())
                dw[:, lo:hi] += _block_matmul(x[rows].t(), part)
            ring.gather_stream(dy, 1, consume)
        return None, dx, dw


# ---------------------------------------------------------------------------
# DTensor in, DTensor out
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor, mesh, spec,
           partial_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """``t``'s local shard under ``spec`` (a plain tensor is read as
    replicated on every rank).  ``partial_axes`` are the mesh axes over
    which the local gradient is a partial sum: a weight the ring reads
    whole on every data shard gets one term from each (JAX's shard_map
    transposes such an input to a psum)."""
    want = placements(mesh, spec)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    names = tuple(mesh.mesh_dim_names)
    grad = [Partial() if names[i] in partial_axes else pl
            for i, pl in enumerate(want)]
    return t.to_local(grad_placements=grad)


def _global(y: torch.Tensor, mesh, spec, shape) -> DTensor:
    shape = torch.Size(shape)
    stride = contiguous_stride(shape)
    return DTensor.from_local(y, mesh, placements(mesh, spec),
                              run_check=False, shape=shape, stride=stride)


# ---------------------------------------------------------------------------
# All-gather matmul
# ---------------------------------------------------------------------------


def _ag_checks(x, ws, p, d, batch_axes, plan) -> None:
    for w in ws:
        if x.shape[1] != w.shape[0]:
            raise ValueError(
                f"contraction mismatch: x {tuple(x.shape)} @ w "
                f"{tuple(w.shape)}")
        _check_div("n", w.shape[1], p)
    _check_div("k", x.shape[1], p)
    if d > 1:
        _check_div("m", x.shape[0], d, f"batch axes {batch_axes!r}")
    if plan.bidirectional and (x.shape[1] // p) % 2 != 0:
        raise ValueError(
            f"serpentine all-gather needs an even per-chip k chunk to split "
            f"across both directions: k={x.shape[1]} over the {p}-way ring "
            f"leaves kb={x.shape[1] // p} (odd); pad k to a multiple of "
            f"{2 * p} or use mode='ring'")


def make_ag_matmul(mesh, axis: str = "model", mode: str = "ring",
                   batch_axes: Tuple[str, ...] = ()):
    """All-gather matmul ``y = x @ w`` with x sharded on k and w on n.

    Ring mode: at step s each rank holds the k-chunk of rank ``(i - s) mod
    p``, multiplies it against the matching row band of its w shard, and
    forwards it; the transfer of step s+1 overlaps the product of step s,
    and the full x never materializes.  Serpentine mode: each chunk is
    halved, the low half streams forward and the high half backward
    (requires ``k % 2p == 0``).  ``batch_axes`` keeps the leading (m) dim
    sharded over the data axes.  Output: n-sharded, ``y == x @ w``."""
    fused = make_ag_matmul_fused(mesh, axis, mode, 1, batch_axes)

    def ag_matmul(x: torch.Tensor, w: torch.Tensor) -> DTensor:
        return fused(x, w)[0]

    return ag_matmul


def make_ag_matmul_fused(mesh, axis: str = "model", mode: str = "ring",
                         n_out: int = 2, batch_axes: Tuple[str, ...] = ()):
    """Fused all-gather matmuls: several column-parallel projections of the
    SAME input (q/k/v, the SwiGLU wg/wi) share one ring -- the chunk hops
    once a step and every step multiplies it against each weight's row
    band.  Each output is n-sharded and equals ``x @ w_i``."""
    p = _axis_sizes(mesh)[axis]
    plan = plan_ring(p, mode)
    d = _batch_extent(mesh, batch_axes)
    lead = _lead_spec(batch_axes)

    def ag_matmul_fused(x: torch.Tensor, *ws: torch.Tensor) -> List[DTensor]:
        if len(ws) != n_out:
            raise ValueError(f"expected {n_out} weights, got {len(ws)}")
        _ag_checks(x, ws, p, d, batch_axes, plan)
        ring = _ring(mesh, axis, mode)
        xl = _local(x, mesh, P(lead, axis))
        wls = [_local(w, mesh, P(None, axis), batch_axes) for w in ws]
        ys = _AgRing.apply(ring, xl, *wls)
        return [_global(y, mesh, P(lead, axis), (x.shape[0], w.shape[1]))
                for y, w in zip(ys, ws)]

    return ag_matmul_fused


# ---------------------------------------------------------------------------
# Reduce-scatter matmul
# ---------------------------------------------------------------------------


def make_rs_matmul(mesh, axis: str = "model", mode: str = "ring",
                   batch_axes: Tuple[str, ...] = ()):
    """Reduce-scatter matmul ``y = x @ w`` with x and w sharded on k.

    Ring mode: each output row block's partial-sum accumulator travels the
    ring once; rank i adds row block ``(i + p-1 - s) mod p`` of its local
    partial product at step s, so no ``(m, n)`` intermediate is ever
    materialized.  Serpentine mode: the low output columns ride the
    forward ring, the high ones the backward ring (requires an even n).
    Output: m-sharded over the batch axes and the ring axis."""
    p = _axis_sizes(mesh)[axis]
    plan = plan_ring(p, mode)
    d = _batch_extent(mesh, batch_axes)
    lead = _lead_spec(batch_axes)
    out_axes = tuple(batch_axes) + (axis,)
    out_lead = out_axes[0] if len(out_axes) == 1 else out_axes

    def rs_matmul(x: torch.Tensor, w: torch.Tensor) -> DTensor:
        if x.shape[1] != w.shape[0]:
            raise ValueError(f"contraction mismatch: x {tuple(x.shape)} @ w "
                             f"{tuple(w.shape)}")
        _check_div("k", x.shape[1], p)
        _check_div("m", x.shape[0], d * p,
                   f"ring axis x batch axes {batch_axes!r}" if d > 1
                   else "ring axis")
        if plan.bidirectional and w.shape[1] % 2 != 0:
            raise ValueError(
                f"serpentine reduce-scatter needs an even n to split the "
                f"output columns across both directions: n={w.shape[1]} "
                f"(odd); pad n or use mode='ring'")
        ring = _ring(mesh, axis, mode)
        y = _RsRing.apply(ring, _local(x, mesh, P(lead, axis)),
                          _local(w, mesh, P(axis, None), batch_axes))
        return _global(y, mesh, P(out_lead, None), (x.shape[0], w.shape[1]))

    return rs_matmul


# ---------------------------------------------------------------------------
# Dispatch (models/layers.py -> overlap layer)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def ring_kernel(mesh, axis: str, kind: str, mode: str,
                batch_axes: Tuple[str, ...] = ()) -> Callable:
    """Memoized kernel factory: one build per (mesh, axis, kind, mode,
    batch_axes).  ``kind`` is "ag" (all-gather), "rs" (reduce-scatter), or
    "agf<N>" (N-output fused all-gather)."""
    if kind.startswith("agf"):
        return make_ag_matmul_fused(mesh, axis=axis, mode=mode,
                                    n_out=int(kind[3:]),
                                    batch_axes=batch_axes)
    make = make_ag_matmul if kind == "ag" else make_rs_matmul
    return make(mesh, axis=axis, mode=mode, batch_axes=batch_axes)


def overlap_matmul(x: torch.Tensor, w: torch.Tensor,
                   parallel: str) -> Optional[torch.Tensor]:
    """Route a ``(..., k) @ (k, n)`` projection through the ring kernels
    when the active sharding rules request ring/serpentine collectives.
    ``parallel`` is the weight's TP orientation: "column" (n sharded ->
    all-gather ring) or "row" (k sharded -> reduce-scatter ring).  Returns
    None when the caller should fall back to a plain product: no active
    overlap context, a ring axis of size 1, or shapes that do not divide
    the ring."""
    ctx = active_overlap()
    if ctx is None:
        return None
    mesh, axis, mode, batch_axes = ctx
    p = _axis_sizes(mesh).get(axis, 1)
    if p <= 1:
        return None
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    n = w.shape[-1]
    m = math.prod(lead) if lead else 1
    d = _batch_extent(mesh, batch_axes)
    if k != w.shape[0] or k % p or m % d:
        return None
    serp = mode == "serpentine"
    if parallel == "column":
        if n % p or (serp and (k // p) % 2):
            return None
        kind = "ag"
    elif parallel == "row":
        if m % (d * p) or (serp and n % 2):
            return None
        kind = "rs"
    else:
        raise ValueError(f"parallel must be 'column' or 'row', got {parallel!r}")
    y = ring_kernel(mesh, axis, kind, mode, batch_axes)(x.reshape(m, k), w)
    return y.reshape(*lead, n)


def overlap_matmul_fused(x: torch.Tensor,
                         ws: Sequence[torch.Tensor]) -> Optional[list]:
    """Route several column-parallel projections of the same ``x`` through
    ONE all-gather ring; None when the caller should fall back to
    per-weight ``tp_matmul`` (the same guards as ``overlap_matmul``, on
    every weight)."""
    ctx = active_overlap()
    if ctx is None or len(ws) < 2:
        return None
    mesh, axis, mode, batch_axes = ctx
    p = _axis_sizes(mesh).get(axis, 1)
    if p <= 1:
        return None
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    m = math.prod(lead) if lead else 1
    d = _batch_extent(mesh, batch_axes)
    if k % p or m % d or (mode == "serpentine" and (k // p) % 2):
        return None
    if any(w.shape[0] != k or w.shape[-1] % p for w in ws):
        return None
    fn = ring_kernel(mesh, axis, f"agf{len(ws)}", mode, batch_axes)
    ys = fn(x.reshape(m, k), *ws)
    return [y.reshape(*lead, w.shape[-1]) for y, w in zip(ys, ws)]
