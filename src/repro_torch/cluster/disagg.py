"""Prefill/decode disaggregation over the DCN level (the port of
``repro.cluster.disagg``).

Prefill-role replicas run chunked prefill into pool pages (a one-token
``generate`` -- publishing the prompt's completed pages into the radix
tree IS the export path, no second code path), then stream those pages
to a decode-role replica as serialized page payloads plus the
page-boundary state snapshots the state families need.  The transfer
SCHEDULE reuses the ring machinery serving already trusts: page ``s``
of the chain moves at the step ``dist.overlap.plan_ring`` would stream
chunk ``s`` -- serpentine mode interleaves the chain from both ends
(both DCN directions carrying half each), ring mode streams it in
order.  Payloads are host numpy arrays (bf16 pools travel as float32),
so they cross a spawn queue as they cross a thread's.  Admission to decode is gated on the LAST page's arrival:
``PageStreamReceiver.payloads`` refuses an incomplete chain, so a
decode replica never prefills against a half-installed prefix.

Token identity holds under GREEDY sampling (the default): stochastic
sampling draws from per-engine generators, which disaggregation by
construction splits across two engines.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.cluster.router import Router, plan_stats
from repro_torch.cluster.worker import Replica


@dataclass
class KVTransfer:
    """One prompt's serialized KV pages in flight.

    ``payloads`` is in LOGICAL chain order (payload ``j`` covers tokens
    ``[j*page_tokens, (j+1)*page_tokens)``); ``order`` is the ring-plan
    transfer schedule over those indices.  ``snaps`` maps page-boundary
    token counts to recurrent-state snapshots (state families)."""

    rid: int
    tokens: List[int]
    page_tokens: int
    payloads: List[Dict[str, Any]]
    order: List[int]
    snaps: Dict[int, Any] = field(default_factory=dict)
    mode: str = "serpentine"
    first_token: Optional[int] = None
    #: Front-side seconds of the prefill-and-export and of the import
    #: (``DisaggCluster.generate`` fills them in).
    export_s: float = 0.0
    import_s: float = 0.0

    @property
    def n_pages(self) -> int:
        return len(self.payloads)

    @property
    def nbytes(self) -> int:
        """Bytes of the page payloads (the snapshots' not counted)."""
        return sum(int(np.asarray(a).nbytes) for pg in self.payloads
                   for a in pg.values())


def transfer_order(n_pages: int, mode: str = "serpentine") -> List[int]:
    """The page-transfer schedule from the ring plan: step ``s`` of a
    ``p``-way ring streams the chunk(s) ``plan_ring`` says rank 0
    consumes at step ``s`` -- one index per step in "ring" mode, the
    forward/backward pair in "serpentine" (the bidirectional-DCN
    interleave).  Every page appears exactly once."""
    if n_pages <= 1:
        return list(range(n_pages))
    from repro_torch.dist.overlap import plan_ring

    rp = plan_ring(n_pages, mode)
    order: List[int] = []
    seen = set()
    for s in range(rp.p):
        steps = (rp.fwd_offsets[s],) if rp.bwd_offsets is None else \
            (rp.fwd_offsets[s], rp.bwd_offsets[s])
        for ix in steps:
            ix = int(ix) % n_pages
            if ix not in seen:
                seen.add(ix)
                order.append(ix)
    return order


class PageStreamReceiver:
    """Decode-side reassembly buffer: pages arrive in transfer order,
    admission unlocks only when the whole chain is resident."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._got: Dict[int, Dict[str, Any]] = {}

    def receive(self, index: int, payload: Dict[str, Any]) -> None:
        if not 0 <= index < self.n_pages:
            raise IndexError(f"page index {index} outside chain of "
                             f"{self.n_pages}")
        self._got[index] = payload

    @property
    def complete(self) -> bool:
        return len(self._got) == self.n_pages

    def payloads(self) -> List[Dict[str, Any]]:
        """The chain in logical order -- the admission gate: raises while
        any page (in particular the last-scheduled one) is missing."""
        if not self.complete:
            missing = sorted(set(range(self.n_pages)) - set(self._got))
            raise RuntimeError(
                f"admission gated on page arrival: missing {missing} "
                f"of {self.n_pages}")
        return [self._got[i] for i in range(self.n_pages)]


# ---------------------------------------------------------------------------
# Transfer endpoints (front-side, over the Replica instruction queue)
# ---------------------------------------------------------------------------


def export_transfer(prefill: Replica, tokens, rid: int = 0,
                    mode: str = "serpentine") -> KVTransfer:
    """Run prefill for ``tokens`` on a prefill-role replica and package
    its completed pages.  The one-token generate is the prefill: chunked
    prefill writes the prompt into pool pages and the radix tree keeps
    them resident, so export is a tree lookup, not a copy out of a live
    slot."""
    toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
    out = prefill.generate([toks.tolist()], 1).wait()
    first = out[0][0] if out and out[0] else None
    exp = prefill.submit("export", toks.tolist()).wait()
    if exp is None or not exp["pages"]:
        raise RuntimeError(
            "prefill replica cached no pages for this prompt (prefix "
            "cache off, family not prefix-cacheable, or prompt shorter "
            "than one page)")
    return KVTransfer(
        rid=rid, tokens=list(exp["tokens"]),
        page_tokens=int(exp["page_tokens"]), payloads=list(exp["pages"]),
        order=transfer_order(len(exp["pages"]), mode),
        snaps=dict(exp["snaps"] or {}), mode=mode, first_token=first)


def import_transfer(decode: Replica, transfer: KVTransfer) -> int:
    """Stream ``transfer``'s pages to a decode-role replica in ring
    order and install them once the LAST page lands.  Returns the number
    of prompt tokens now resident on the decode side."""
    recv = PageStreamReceiver(transfer.n_pages)
    for ix in transfer.order:
        recv.receive(ix, transfer.payloads[ix])
    payloads = recv.payloads()          # the admission gate
    return decode.submit(
        "import", (transfer.tokens, payloads, transfer.snaps)).wait()


class DisaggCluster:
    """P prefill-role + D decode-role replicas: prompts prefill on the P
    side, their pages stream across, and decode admits against a local
    radix hit covering the whole transferred prefix."""

    def __init__(self, prefill: List[Replica], decode: List[Replica],
                 router: Optional[Router] = None, page_tokens: int = 0,
                 mode: str = "serpentine"):
        if not prefill or not decode:
            raise ValueError("disaggregation needs >=1 prefill and >=1 "
                             "decode replica")
        self.prefill = prefill
        self.decode = decode
        self.mode = mode
        self.router = router or Router(len(decode), policy="free_pages",
                                       page_tokens=page_tokens)
        self._rr = 0
        self._rid = 0
        self.last_transfer: Optional[KVTransfer] = None

    @classmethod
    def from_plan(cls, plan, factory, split: str = "1:1",
                  transport: str = "thread", policy: str = "free_pages",
                  mode: str = "serpentine") -> "DisaggCluster":
        """Split the plan's fleet into prefill:decode roles.  ``split``
        is "P:D"; P+D must equal ``plan.replicas()`` -- the role split
        partitions the planned fleet, it does not grow it."""
        p, d = (int(x) for x in split.split(":"))
        n = plan.replicas()
        if p + d != n or p < 1 or d < 1:
            raise ValueError(f"--disagg {split} does not partition the "
                             f"planned fleet of {n} replicas")
        page = plan.page_plan() or {}
        prefill = [Replica(factory, replica=i, role="prefill",
                           transport=transport,
                           default_stats=plan_stats(plan, i, "prefill"))
                   for i in range(p)]
        decode = [Replica(factory, replica=p + i, role="decode",
                          transport=transport,
                          default_stats=plan_stats(plan, p + i, "decode"))
                  for i in range(d)]
        router = Router(d, policy=policy,
                        page_tokens=int(page.get("page_tokens") or 0))
        return cls(prefill, decode, router=router, mode=mode)

    def stats(self):
        return [r.stats() for r in self.prefill + self.decode]

    def generate(self, tokens, max_new_tokens: int = 16,
                 on_token=None) -> List[int]:
        """One request end to end: prefill -> page stream -> routed
        decode.  The decode replica re-submits the FULL prompt; its radix
        tree already holds the transferred pages, so prefill there covers
        only the sub-page tail."""
        pre = self.prefill[self._rr % len(self.prefill)]
        self._rr += 1
        self._rid += 1
        t0 = time.perf_counter()
        transfer = export_transfer(pre, tokens, rid=self._rid,
                                   mode=self.mode)
        transfer.export_s = time.perf_counter() - t0
        by = {s.replica: s for s in
              (r.stats() for r in self.decode)}
        stats = []
        for j, rep in enumerate(self.decode):
            st = by[rep.replica]
            st.replica = j              # router indexes decode-side slots
            stats.append(st)
        j = self.router.route(stats, tokens=tokens)
        t0 = time.perf_counter()
        import_transfer(self.decode[j], transfer)
        transfer.import_s = time.perf_counter() - t0
        self.last_transfer = transfer
        out = self.decode[j].generate(
            [np.asarray(tokens).reshape(-1).tolist()], max_new_tokens,
            on_token=on_token).wait()
        return out[0] if out else []

    def close(self) -> None:
        for rep in self.prefill + self.decode:
            rep.close()
