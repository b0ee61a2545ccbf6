"""Request placement over the replica fleet (the port of
``repro.cluster.router``).

Three pluggable policies, all reading the same ``ReplicaStats`` ticks:

  * ``round_robin`` -- cycle the admissible replicas (the baseline the
    benchmark A/Bs against).
  * ``least_loaded`` -- fewest outstanding requests (``queued +
    active``), ties to the lowest replica id.
  * ``free_pages`` -- the headline memory-aware policy: admit to the
    replica whose page pool has the MOST free pages, ties to the lowest
    replica id.  This is Silva et al.'s branch-and-bound result (load
    balance by *available memory*, not work count) applied at the DCN
    level: a replica holding a long prompt's pages reports low
    ``free_pages`` while the work-count view still says "one request",
    so memory-skewed workloads route around it.

Prefix AFFINITY is orthogonal to the policy: the request's leading
page-aligned tokens are hashed, and a prefix that already landed
somewhere goes back to that replica (its radix tree holds the pages --
a cross-replica miss would re-prefill the whole shared prompt).  The
policy decides only the FIRST placement of each prefix.

Drained replicas are never admitted.  A straggler detector (an object
with ``record(replica, seconds)``, ``stragglers()`` and ``forget(replica)``,
as the reference's ``ft.resilience.StragglerPolicy``) can drive draining
from routed-request latency:
``note_latency`` feeds per-replica TTFT samples, ``sweep_stragglers``
drains the median+k*MAD outliers, and ``undrain`` forgets a replica's
history so re-admission starts from fresh samples.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.worker import Replica, ReplicaStats

POLICIES = ("round_robin", "least_loaded", "free_pages")


def plan_stats(plan, replica: int, role: str = "serve") -> ReplicaStats:
    """A fresh replica's advertised telemetry: the PLAN's pool geometry
    with the whole pool free.  Until a replica's first tick arrives this
    is what the router sees, so the ``free_pages`` policy spreads onto
    never-used replicas instead of starving them behind a served one."""
    ptab = dict(plan.page_table() or {})
    page = dict(plan.page_plan() or {})
    total = int(ptab.get("pages_total") or 0)
    return ReplicaStats(replica=replica, role=role, free_pages=total,
                        pages_total=total,
                        page_tokens=int(page.get("page_tokens") or 0))


class Router:
    """Stateless-per-request placement over ``ReplicaStats`` snapshots
    (the affinity map and round-robin cursor are the only state)."""

    def __init__(self, n: int, policy: str = "free_pages",
                 page_tokens: int = 0, affinity: bool = True,
                 straggler=None, obs=None, tracer=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.n = n
        self.policy = policy
        self.page_tokens = page_tokens
        self.affinity = affinity
        self.straggler = straggler
        self.drained: set = set()
        self._rr = 0
        self._prefix_home: Dict[int, int] = {}
        # Placement decisions count into the registry and land in the
        # trace (the router's tracer uses its own pid, so a merged cluster
        # trace shows who sent each request where beside the replicas
        # serving them).
        self.obs = obs
        self.tracer = tracer

    # --------------------------------------------------------- placement
    def _prefix_key(self, tokens) -> Optional[int]:
        t = self.page_tokens
        if not self.affinity or not t or tokens is None:
            return None
        toks = np.asarray(tokens).reshape(-1)
        blocks = int(toks.shape[0]) // t
        if blocks <= 0:
            return None
        return hash(tuple(int(x) for x in toks[:blocks * t]))

    def route(self, stats: Sequence[ReplicaStats], tokens=None) -> int:
        """Pick the replica id for one request.  ``stats`` is one
        ``ReplicaStats`` per replica (any order); ``tokens`` enables
        prefix affinity."""
        by = {s.replica: s for s in stats}
        live = [i for i in sorted(by)
                if i not in self.drained and not by[i].drained]
        if not live:
            raise RuntimeError("no admissible replicas (all drained)")
        key = self._prefix_key(tokens)
        if key is not None:
            home = self._prefix_home.get(key)
            if home in live:
                self._record(home, by, affinity=True)
                return home
        if self.policy == "round_robin":
            pick = live[self._rr % len(live)]
            self._rr += 1
        elif self.policy == "least_loaded":
            pick = min(live, key=lambda i: (by[i].queued + by[i].active, i))
        else:                                       # free_pages
            # Memory first; outstanding load breaks free-page ties (an
            # instant burst arrives before any pool telemetry can move),
            # then the lowest replica id -- fully deterministic.
            pick = max(live, key=lambda i: (
                by[i].free_pages, -(by[i].queued + by[i].active), -i))
        if key is not None:
            self._prefix_home[key] = pick
        self._record(pick, by, affinity=False)
        return pick

    def _record(self, pick: int, by, affinity: bool) -> None:
        if self.obs is not None:
            self.obs.inc("route_decisions")
            if affinity:
                self.obs.inc("route_affinity_hits")
        if self.tracer is not None:
            self.tracer.instant(
                "route",
                args={"pick": pick, "policy": self.policy,
                      "affinity": affinity,
                      "free_pages": by[pick].free_pages})

    # ----------------------------------------------------- drain lifecycle
    def drain(self, replica: int) -> None:
        self.drained.add(replica)

    def undrain(self, replica: int) -> None:
        self.drained.discard(replica)
        if self.straggler is not None:
            self.straggler.forget(replica)

    def note_latency(self, replica: int, seconds: float) -> None:
        if self.straggler is not None:
            self.straggler.record(replica, seconds)

    def sweep_stragglers(self) -> List[int]:
        """Drain every replica the straggler detector flags; returns the
        NEWLY drained ids."""
        if self.straggler is None:
            return []
        fresh = [h for h in self.straggler.stragglers()
                 if h not in self.drained]
        for h in fresh:
            self.drain(h)
        return fresh


# ---------------------------------------------------------------------------
# The cluster front: N replicas behind one router
# ---------------------------------------------------------------------------


class ClusterRequest:
    """One routed request: where it landed, its streaming call, and the
    TTFT clock (measured from SUBMISSION, so a drain/requeue's wait on
    the first replica still counts against it)."""

    def __init__(self, rid: int, tokens, max_new: int, on_token=None):
        self.rid = rid
        self.tokens = tokens
        self.max_new = max_new
        self.on_token = on_token
        self.replica: Optional[int] = None
        self.call = None
        self.t_submit = time.monotonic()

    def done(self) -> bool:
        return self.call is not None and self.call.done()

    def result(self, timeout: Optional[float] = 60.0) -> List[int]:
        out = self.call.wait(timeout)
        return out[0] if out else []

    def ttft(self) -> Optional[float]:
        t = self.call.first_token_time if self.call is not None else None
        return None if t is None else t - self.t_submit


class ServeCluster:
    """N ``Replica`` hosts behind one ``Router`` -- the planner's
    outermost consumer.  ``from_plan`` reads the fleet width straight off
    the decode plan's DCN level (``plan.replicas()``), so the cluster
    realizes the run-time's placement decision rather than a config
    file's."""

    def __init__(self, replicas: List[Replica], router: Router):
        from repro_torch.obs import Registry, Tracer

        self.replicas = replicas
        self.router = router
        self._lock = threading.Lock()
        self._next_rid = 0
        self._inflight: List[ClusterRequest] = []
        # The router records its placements under its own pid (one past the
        # replica range) so ``trace_events`` can merge the router and every
        # replica onto one Perfetto timeline.
        self.obs = Registry()
        self.tracer = Tracer(pid=len(replicas), process_name="router")
        self.obs.set("fleet_replicas", len(replicas), unit="replicas")
        if router.obs is None:
            router.obs = self.obs
        if router.tracer is None:
            router.tracer = self.tracer

    @classmethod
    def from_plan(cls, plan, factory, transport: str = "thread",
                  policy: str = "free_pages", affinity: bool = True,
                  straggler=None) -> "ServeCluster":
        n = plan.replicas()
        page = plan.page_plan() or {}
        replicas = [Replica(factory, replica=i, transport=transport,
                            default_stats=plan_stats(plan, i))
                    for i in range(n)]
        router = Router(n, policy=policy,
                        page_tokens=int(page.get("page_tokens") or 0),
                        affinity=affinity, straggler=straggler)
        return cls(replicas, router)

    # ----------------------------------------------------------- serving
    def stats(self) -> List[ReplicaStats]:
        out = []
        for rep in self.replicas:
            st = rep.stats()
            st.drained = rep.replica in self.router.drained
            out.append(st)
        return out

    def _dispatch(self, cr: ClusterRequest) -> None:
        i = self.router.route(self.stats(), tokens=cr.tokens)
        rep = self.replicas[i]
        cr.replica = i

        def done(call, _i=i):
            if call.err is None and call.first_token_time is not None:
                self.router.note_latency(_i,
                                         call.first_token_time - cr.t_submit)

        cr.call = rep.generate([cr.tokens], cr.max_new,
                               on_token=cr.on_token, on_done=done)

    def submit(self, tokens, max_new_tokens: int = 16,
               on_token=None) -> ClusterRequest:
        """Route one request and start it (always streamed, so TTFT is
        observable).  Returns immediately; ``ClusterRequest.result()``
        blocks for the tokens."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        cr = ClusterRequest(rid, tokens, max_new_tokens, on_token=on_token)
        with self._lock:
            self._inflight.append(cr)
        self._dispatch(cr)
        return cr

    def generate(self, prompts: Sequence[Any], max_new_tokens: int = 16
                 ) -> List[List[int]]:
        """Blocking convenience: route every prompt, wait for all, return
        token lists in submission order (the token-identity surface)."""
        crs = [self.submit(p, max_new_tokens) for p in prompts]
        return [cr.result() for cr in crs]

    # ------------------------------------------------------ observability
    def trace_events(self, last: Optional[int] = None) -> List[Dict]:
        """The whole fleet's Chrome trace on ONE timeline: the router's
        placement instants (its own pid) merged with every replica's
        request spans (pid = replica id), sorted by timestamp."""
        from repro_torch.obs import merge_events

        lists = [self.tracer.chrome_events(last)]
        for rep in self.replicas:
            lists.append(rep.trace(last))
        return merge_events(*lists)

    def prometheus(self) -> str:
        """Prometheus text exposition for the fleet: the front's own
        registry plus every replica's forwarded snapshot and scalar
        stats, labelled by replica/role."""
        from dataclasses import asdict

        from repro_torch.obs import prometheus_lines

        lines = [self.obs.to_prometheus(labels={"process": "router"})
                 .rstrip("\n")]
        for st in self.stats():
            labels = {"replica": str(st.replica), "role": st.role}
            d = asdict(st)
            snap = d.pop("metrics", {}) or {}
            d.pop("replica", None)
            d.pop("role", None)
            d.pop("batching", None)
            lines.extend(prometheus_lines(
                {f"replica_{k}": v for k, v in d.items()}, labels))
            lines.extend(prometheus_lines(snap, labels))
        return "\n".join(lines) + "\n"

    # -------------------------------------------------------------- drain
    def drain_replica(self, replica: int) -> List[int]:
        """Stop admitting to ``replica`` and requeue its not-yet-started
        requests through the router.  Returns the requeued rids."""
        self.router.drain(replica)
        cancelled = self.replicas[replica].cancel_pending()
        moved = []
        with self._lock:
            inflight = list(self._inflight)
        for cr in inflight:
            if cr.call in cancelled:
                self._dispatch(cr)
                moved.append(cr.rid)
        return moved

    def sweep_stragglers(self) -> List[int]:
        """Drain-and-requeue every straggling replica (router verdict)."""
        moved = []
        for rep in self.router.sweep_stragglers():
            moved.extend(self.drain_replica(rep))
        return moved

    def close(self) -> None:
        for rep in self.replicas:
            rep.close()
