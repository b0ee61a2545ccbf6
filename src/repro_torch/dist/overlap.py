"""The plan-time ring schedule of ``repro.dist.overlap``: ``RingPlan`` and
``plan_ring``, over the port's own ``core.schedule.ring_stream_order``.

Two streaming orders, chosen by the paper's scheduler:

  * ``ring``       -- CC order: one direction, the whole chunk hops
    forward each step.
  * ``serpentine`` -- SRRC order: both directions at once, each carrying
    half of every chunk.

``cluster.disagg.transfer_order`` reads it to order a prompt's KV pages
on their way from a prefill replica to a decode replica.  The ring
collective matmuls that run these plans (all-gather and reduce-scatter
matmuls whose steps run ``matmul_cc``) are not here yet: they come with
the distribution slice, over NCCL.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

from repro_torch.core.schedule import ring_stream_order

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
