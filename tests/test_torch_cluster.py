"""``repro_torch.cluster``'s host side against ``repro.cluster``: the
router's picks, the page transfer order, the planner's DCN level, and the
worker protocol and HTTP front end on the stub engine.

  * Router parity: on the same seeded sequences of ``ReplicaStats``,
    drains, undrains, latency samples and straggler sweeps, the port's
    ``Router`` and the reference's make the same picks (or both refuse)
    for all three policies, with and without prefix affinity.
  * ``transfer_order`` and ``plan_ring`` equal the reference's for 1..16
    pages in both modes.
  * The DCN ``LevelPlan`` of the port's planner equals the reference's on
    the same hand-built multi-host hierarchy; ``plan_decode`` raises
    ``PlanError`` at ``DCN`` without ``cluster=`` in both packages, and
    ``cluster=2`` leaves the per-replica page table as the single plan's.
  * The worker protocol over both transports, drain/requeue, the
    straggler sweep and the HTTP front end run on the stub engine (their
    timing is wall-clock; no model runs here).
"""

import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

from repro.cluster import Router as RefRouter
from repro.cluster import ReplicaStats as RefStats
from repro.cluster import transfer_order as ref_transfer_order
from repro.configs import get_model_config as ref_config
from repro.core import plan as ref_plan
from repro.core.hierarchy import MemoryLevel as RefLevel
from repro.dist.overlap import plan_ring as ref_plan_ring
from repro.ft.resilience import StragglerPolicy
from repro.hw.tpu import chip_spec
from repro.serve.engine import PlanError as RefPlanError
from repro.serve.engine import plan_decode as ref_plan_decode
from repro_torch.cluster import (POLICIES, ClusterServer, DisaggCluster,
                                 PageStreamReceiver, Replica, ReplicaStats,
                                 Router, ServeCluster, StubSpec,
                                 transfer_order)
from repro_torch.configs import get_model_config
from repro_torch.core import plan as my_plan
from repro_torch.dist.overlap import plan_ring
from repro_torch.hw import h100_spec
from repro_torch.serve.engine import PlanError, plan_decode

#: Token prompts drawn for routing: a few shared page-aligned prefixes so
#: affinity finds homes, and short ones with no key.
_PREFIXES = [list(range(8)), list(range(100, 108)), [7] * 12, [1, 2, 3]]


def _stats_pair(rng, n, drained_flags):
    free = rng.integers(0, 16, n)
    queued = rng.integers(0, 3, n)
    active = rng.integers(0, 2, n)
    mine = [ReplicaStats(replica=i, free_pages=int(free[i]),
                         queued=int(queued[i]), active=int(active[i]),
                         drained=bool(drained_flags[i])) for i in range(n)]
    ref = [RefStats(replica=i, free_pages=int(free[i]),
                    queued=int(queued[i]), active=int(active[i]),
                    drained=bool(drained_flags[i])) for i in range(n)]
    order = rng.permutation(n)            # any order of the stats list
    return [mine[i] for i in order], [ref[i] for i in order]


def _route(router, stats, tokens):
    try:
        return router.route(stats, tokens=tokens)
    except RuntimeError as e:
        return f"refused: {e}"


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 4),
       policy=st.sampled_from(POLICIES), affinity=st.booleans(),
       page_tokens=st.sampled_from([0, 2, 4]))
def test_router_picks_equal_the_reference(seed, n, policy, affinity,
                                          page_tokens):
    rng = np.random.default_rng(seed)
    mine = Router(n, policy, page_tokens=page_tokens, affinity=affinity,
                  straggler=StragglerPolicy(k=1.0, min_samples=2))
    ref = RefRouter(n, policy, page_tokens=page_tokens, affinity=affinity,
                    straggler=StragglerPolicy(k=1.0, min_samples=2))
    picks = []
    for _ in range(40):
        op = rng.integers(0, 10)
        if op < 6:
            flags = rng.random(n) < 0.15
            s_mine, s_ref = _stats_pair(rng, n, flags)
            base = _PREFIXES[rng.integers(0, len(_PREFIXES))]
            tokens = base + [int(t) for t in rng.integers(0, 50,
                                                          rng.integers(0, 5))]
            a, b = _route(mine, s_mine, tokens), _route(ref, s_ref, tokens)
            assert a == b, (seed, a, b)
            picks.append(a)
        elif op == 6:
            i = int(rng.integers(0, n))
            mine.drain(i)
            ref.drain(i)
        elif op == 7:
            i = int(rng.integers(0, n))
            mine.undrain(i)
            ref.undrain(i)
        elif op == 8:
            i = int(rng.integers(0, n))
            s = float(rng.choice([0.01, 0.02, 5.0]))
            mine.note_latency(i, s)
            ref.note_latency(i, s)
        else:
            assert mine.sweep_stragglers() == ref.sweep_stragglers()
        assert mine.drained == ref.drained
    assert picks                    # the sequence routed at least once


# ---------------------------------------------------------------------------
# Transfer order and the ring plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ring", "serpentine"])
def test_transfer_order_and_ring_plan_equal_the_reference(mode):
    for p in range(1, 17):
        order = transfer_order(p, mode)
        assert order == ref_transfer_order(p, mode), (p, mode)
        assert sorted(order) == list(range(p))
        mine, ref = plan_ring(p, mode), ref_plan_ring(p, mode)
        for f in ("p", "mode", "fwd_offsets", "fwd_perm", "bwd_offsets",
                  "bwd_perm"):
            assert getattr(mine, f) == getattr(ref, f), (p, mode, f)
        assert mine.describe() == ref.describe()


def test_receiver_gates_admission_on_last_page():
    recv = PageStreamReceiver(3)
    recv.receive(0, {"k": 0})
    recv.receive(2, {"k": 2})
    assert not recv.complete
    with pytest.raises(RuntimeError, match="gated"):
        recv.payloads()
    with pytest.raises(IndexError):
        recv.receive(3, {"k": 3})
    recv.receive(1, {"k": 1})
    assert recv.payloads() == [{"k": 0}, {"k": 1}, {"k": 2}]


# ---------------------------------------------------------------------------
# The planner's DCN level
# ---------------------------------------------------------------------------

#: The port's level names as the reference's planner knows them.
_REF_NAMES = {"NVLINK": "ICI", "REG": "VREG"}


def _as_reference(tree):
    d = tree.to_dict()
    node = d
    while node is not None:
        node["name"] = _REF_NAMES.get(node["name"], node["name"])
        node = node["child"]
    return RefLevel.from_dict(d)


def _host_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("hosts", [2, 3, 4])
def test_dcn_level_equals_the_reference(hosts):
    """The hand-built tree: ``h100_hierarchy`` at a small HBM over
    ``hosts`` hosts, the same tree in the reference's package (its ICI in
    place of NVLINK); decode workloads whose fleet KV fits one host, needs
    several, or does not fit, seeded by 1..hosts replicas."""
    h = h100_spec(hbm_bytes=8 << 30).hierarchy(hosts=hosts)
    r = _as_reference(h)
    assert h.name == "DCN" and h.child.name == "NVLINK"
    assert len(h.child.siblings) == hosts and h.size == hosts * h.child.size
    kv = dict(kv_bytes_per_token=2048, kv_layers=4, kv_heads=8,
              max_tokens=512)
    for state in (1 << 20, 3 << 30, 20 << 30):
        for workers in range(1, hosts + 1):
            hp = my_plan.plan_run(
                h, my_plan.Workload(state_bytes=state,
                                    replicated_bytes=1 << 30, **kv),
                my_plan.PlanPolicy(n_workers=workers))
            rp = ref_plan.plan_run(
                r, ref_plan.Workload(state_bytes=state,
                                     replicated_bytes=1 << 30, **kv),
                ref_plan.PlanPolicy(n_workers=workers))
            mine, ref = hp.level("DCN"), rp.level("DCN")
            assert mine.detail["placement"] == ref.detail["placement"] \
                == "replicas"
            for f in ("np_raw", "np", "extent", "fits", "budget_bytes",
                      "granule_bytes", "n_workers", "partition_bytes"):
                assert getattr(mine, f) == getattr(ref, f), (state, f)
            assert dict(mine.detail, tcl_level="ICI") == dict(ref.detail)
            assert hp.replicas() == rp.replicas() >= workers
            assert hp.describe()[0] == rp.describe()[0]
            # Below the DCN level each replica plans as one host.
            assert hp.level("NVLINK").n_workers == 1


def test_plan_decode_refuses_a_dcn_plan_without_cluster():
    cfg = get_model_config("llama3.2-1b").reduced()
    spec = h100_spec(smem_bytes=16 << 10)
    with pytest.raises(PlanError) as ei:
        plan_decode(cfg, max_len=64, spec=spec,
                    hierarchy=spec.hierarchy(hosts=2))
    assert ei.value.level == "DCN"
    assert ei.value.plan is not None and \
        ei.value.plan.level("DCN") is not None
    rspec = chip_spec(vmem_bytes=16 << 10, vmem_reserved_bytes=0)
    with pytest.raises(RefPlanError) as ri:
        ref_plan_decode(ref_config("llama3.2-1b").reduced(), _host_mesh(),
                        max_len=64, spec=rspec,
                        hierarchy=rspec.hierarchy(mesh_devices=1, hosts=2))
    assert ri.value.level == ei.value.level


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_cluster_plan_keeps_the_replica_geometry(arch, reduced):
    cfg = get_model_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    spec = h100_spec(smem_bytes=16 << 10) if reduced else h100_spec()
    fleet = plan_decode(cfg, max_len=4096, batch=8, spec=spec, cluster=2)
    single = plan_decode(cfg, max_len=4096, batch=8, spec=spec)
    dcn = fleet.level("DCN")
    assert fleet.replicas() == dcn.np == 2
    assert dcn.detail["placement"] == "replicas"
    assert dict(fleet.page_table()) == dict(single.page_table())
    assert dict(fleet.page_plan()) == dict(single.page_plan())
    assert single.replicas() == 1 and single.level("DCN") is None
    assert plan_decode(cfg, max_len=4096, batch=8, spec=spec,
                       cluster=1).level("DCN") is None


# ---------------------------------------------------------------------------
# Worker protocol (stub engines)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["thread", "proc"])
def test_replica_streams_and_ticks(transport):
    rep = Replica(StubSpec(), replica=1, transport=transport)
    try:
        got = []
        call = rep.generate([[5, 5]], 3, on_token=lambda i, t: got.append(t))
        assert call.wait(120) == [[10, 11, 12]]
        assert got == [10, 11, 12]          # streamed == returned
        assert call.first_token_time is not None
        for _ in range(200):                # the tick is asynchronous
            if rep.last_stats is not None:
                break
            time.sleep(0.05)
        st = rep.stats()
        assert st.replica == 1 and st.tokens == 3
        bad = rep.submit("no_such_op", None)
        with pytest.raises(RuntimeError, match="no_such_op"):
            bad.wait(60)
        assert rep.generate([[1]], 1).wait(60) == [[1]]
        assert rep.submit("import", ([1], [], None)).wait(60) == 0
    finally:
        rep.close()
    assert not rep._worker.is_alive()


def test_dead_worker_fails_its_calls():
    rep = Replica(StubSpec(delay_s=0.5), replica=0, transport="proc")
    try:
        first = rep.generate([[1]], 1)
        assert first.wait(120) == [[1]]
        slow = rep.generate([[2]], 50)
        rep._worker.kill()
        with pytest.raises(RuntimeError, match="exited"):
            slow.wait(60)
    finally:
        rep.close()


def test_drain_requeues_pending_requests():
    slow = Replica(StubSpec(delay_s=0.2), replica=0, transport="thread")
    fast = Replica(StubSpec(), replica=1, transport="thread")
    cluster = ServeCluster([slow, fast], Router(2, "round_robin",
                                                affinity=False))
    try:
        first = cluster.submit([1], 4)      # replica 0, starts at once
        assert first.replica == 0
        for _ in range(100):
            if first.call.started:
                break
            time.sleep(0.01)
        queued = cluster.submit([2], 2)     # round robin -> 1
        queued2 = cluster.submit([3], 2)    # round robin -> 0: queues
        assert queued2.replica == 0
        moved = cluster.drain_replica(0)
        assert queued2.rid in moved and queued2.replica == 1
        assert queued2.result(30) == [3, 4]
        assert queued.result(30) == [2, 3]
        assert first.result(30) == [1, 2, 3, 4]     # in flight: finishes
        assert cluster.submit([4], 1).replica == 1  # drained: no new work
        assert [s.drained for s in cluster.stats()] == [True, False]
    finally:
        cluster.close()


def test_straggler_sweep_drains_the_slow_replica():
    """Routed TTFTs feed the detector: the replica with a 0.3 s per-token
    delay is swept (drained) and the rest stay admissible."""
    reps = [Replica(StubSpec(delay_s=0.3 if i == 2 else 0.0), replica=i)
            for i in range(3)]
    cluster = ServeCluster(reps, Router(
        3, "round_robin", affinity=False,
        straggler=StragglerPolicy(k=1.0, min_samples=2)))
    try:
        crs = [cluster.submit([i], 1) for i in range(6)]
        for cr in crs:
            cr.result(60)
        for _ in range(100):        # on_done runs on the demux thread
            if all(len(v) >= 2 for v in cluster.router.straggler
                   .history.values()) and len(cluster.router.straggler
                                              .history) == 3:
                break
            time.sleep(0.01)
        assert cluster.sweep_stragglers() == []     # nothing queued
        assert cluster.router.drained == {2}
        cluster.router.undrain(2)
        assert cluster.router.straggler.history.get(2) is None
    finally:
        cluster.close()


def test_disagg_split_must_partition_the_planned_fleet():
    cfg = get_model_config("llama3.2-1b").reduced()
    plan = plan_decode(cfg, max_len=64, spec=h100_spec(smem_bytes=16 << 10),
                       cluster=2)
    with pytest.raises(ValueError, match="partition"):
        DisaggCluster.from_plan(plan, StubSpec(), split="2:2")


# ---------------------------------------------------------------------------
# HTTP front end (stub cluster: protocol only)
# ---------------------------------------------------------------------------


def test_http_generate_streams_chunked_ndjson():
    cluster = ServeCluster([Replica(StubSpec(), replica=i)
                            for i in range(2)],
                           Router(2, "round_robin", affinity=False))
    srv = ClusterServer(cluster).start()
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == \
                {"ok": True, "replicas": 2, "admissible": 2}
        req = urllib.request.Request(
            f"{base}/generate",
            data=json.dumps({"tokens": [1, 2],
                             "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers.get("Transfer-Encoding") == "chunked"
            lines = [json.loads(x) for x in r.read().splitlines()
                     if x.strip()]
        assert [ln["token"] for ln in lines if "token" in ln] == [3, 4, 5]
        assert lines[-1]["done"] and lines[-1]["tokens"] == [3, 4, 5]
        with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["policy"] == "round_robin"
        assert len(doc["replicas"]) == 2
        assert {"free_pages", "slots_free", "prefix_nodes"} <= \
            set(doc["replicas"][0])
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'replica_free_pages{replica="1",role="serve"}' in text
        with urllib.request.urlopen(f"{base}/trace?n=5", timeout=10) as r:
            assert "traceEvents" in json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert e.value.code == 404
    finally:
        srv.close()
        cluster.close()


# ---------------------------------------------------------------------------
# Shared state under threads
# ---------------------------------------------------------------------------


def test_concurrent_submits_and_launch_counts_lose_nothing():
    """Many front threads submit to one thread replica while the demux
    pops their replies, and many threads count paged launches (the thread
    transport launches from one thread per replica), at a 1 us switch
    interval: every call gets its own reply, and no count is lost."""
    import sys
    import threading

    from repro_torch.kernels import paged_attention as pa

    rep = Replica(StubSpec(), replica=0, transport="thread")
    before = {n: getattr(pa, n) for n in ("LAUNCHES", "LAUNCHES_SPLIT",
                                          "LAUNCHES_SIMT")}
    interval = sys.getswitchinterval()
    errors = []

    def front(k):
        try:
            for j in range(20):
                base = 1000 * k + j
                assert rep.generate([[base]], 1).wait(60) == \
                    [[base % 997]]
                pa._count("split" if j % 2 else "simt")
        except Exception as e:                      # noqa: BLE001
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=front, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
        rep.close()
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert not rep._calls
    assert pa.LAUNCHES - before["LAUNCHES"] == 16 * 20
    assert pa.LAUNCHES_SPLIT - before["LAUNCHES_SPLIT"] == 16 * 10
    assert pa.LAUNCHES_SIMT - before["LAUNCHES_SIMT"] == 16 * 10
