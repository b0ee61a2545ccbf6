"""``repro_torch.cluster`` serving real engines on the CPU, held to the JAX
package's single engine.

  * A routed 2-replica cluster over the thread transport streams and
    returns, request by request, the greedy tokens of the synchronous JAX
    paged engine (one request a call, radix cache on) for the reference's
    four cluster families, on the same parameters and page geometry; each
    replica's pool geometry is the plan's page table.
  * Disaggregated prefill/decode 1:1 is token-identical to the JAX single
    engine, and the decode replica makes a real prefix hit over the
    transferred pages.
  * The same protocol over the spawn transport (``EngineSpec``,
    ``device="cpu"``) gives the port's single engine's tokens, for a
    routed cluster and a disaggregated one.
  * A merged cluster trace shows pids {0, 1, 2}: two replicas and the
    router.  The one-card HBM split (``replica_kv_budget``) reaches each
    replica's engine.  ``python -m repro_torch.launch.serve --cluster 2``
    and ``--disagg 1:1`` run on the CPU.

Prompt lengths stay off page boundaries, where the JAX paged engine loses
the first decode token's K/V (ROADMAP Queue 3).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServePolicy as RefPolicy
from repro_torch.cluster import (DisaggCluster, EngineSpec, ServeCluster,
                                 export_transfer, import_transfer,
                                 replica_kv_budget)
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import ServeEngine, ServePolicy
from repro_torch.serve.engine import kv_budget, plan_decode
from test_torch_serve_moe import _host_mesh, _synchronous

#: The reference cluster test's families: dense, MoE (sliding window),
#: hybrid SSM, xLSTM.
FOUR_FAMILIES = ["llama3.2-1b", "mixtral-8x7b", "zamba2-1.2b", "xlstm-1.3b"]
#: The same tiny leaf on both sides: small pages, several a prompt.
LEAF = 16 << 10
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _pair(arch, max_new, max_len):
    """The synchronous JAX paged engine (radix cache on, one slot) and a
    factory of the port's engines on its parameters, leaf and policy."""
    pol = dict(max_new_tokens=max_new, max_len=max_len, max_slots=1,
               batching="paged", prefix_cache="radix")
    ref_spec = chip_spec(vmem_bytes=LEAF, vmem_reserved_bytes=0)
    ref = _synchronous(RefEngine(ref_config(arch).reduced(), _host_mesh(),
                                 policy=RefPolicy(**pol), spec=ref_spec))
    cfg = get_model_config(arch).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                               "cpu")
    spec = h100_spec(smem_bytes=LEAF, hbm_bytes=ref_spec.hbm_bytes)

    def factory(replica):
        return ServeEngine(cfg, ServePolicy(**pol), params=params,
                           spec=spec, device="cpu", replica=replica)

    plan = plan_decode(cfg, max_len=max_len, dtype_bytes=4, spec=spec,
                       cluster=2)
    return cfg, ref, factory, plan


@pytest.mark.parametrize("arch", FOUR_FAMILIES)
def test_routed_cluster_token_identical_to_jax_engine(arch):
    cfg, ref, factory, plan = _pair(arch, max_new=3, max_len=64)
    t = int(plan.page_plan()["page_tokens"]) if plan.page_plan() else 0
    rng = np.random.default_rng(0)
    lens = (9, 13, 11, 10)
    assert not t or all(n % t for n in lens)     # off the JAX fault
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32).tolist()
               for n in lens]
    want = [ref.generate([p], 3)[0] for p in prompts]
    cluster = ServeCluster.from_plan(plan, factory, transport="thread",
                                     policy="free_pages")
    try:
        assert len(cluster.replicas) == plan.replicas() == 2
        streamed = {i: [] for i in range(len(prompts))}
        crs = [cluster.submit(p, 3, on_token=lambda _i, tok, j=j: (
            streamed[j].clear() if tok is None else streamed[j].append(tok)))
            for j, p in enumerate(prompts)]
        got = [cr.result(timeout=600) for cr in crs]
        assert got == want, arch
        assert [streamed[j] for j in range(len(prompts))] == want, arch
        assert {cr.replica for cr in crs} == {0, 1}     # both served
        assert all(cr.ttft() is not None for cr in crs)
        for rep in cluster.replicas:
            assert rep.engine.metrics["plan_page_table"] == \
                dict(ref.plan.page_table() or {}), arch
    finally:
        cluster.close()


def test_disagg_token_identical_to_jax_engine_with_a_prefix_hit():
    cfg, ref, factory, plan = _pair("llama3.2-1b", max_new=4, max_len=128)
    t = int(plan.page_plan()["page_tokens"])
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, 2 * t + 3, dtype=np.int32).tolist()
    want = ref.generate([prompt], 4)[0]
    dc = DisaggCluster.from_plan(plan, factory, split="1:1",
                                 transport="thread")
    try:
        got = dc.generate(prompt, 4)
        assert got == want
        # The transferred pages produced a real prefix hit on decode.
        dec = dc.decode[0].engine
        assert dec.metrics["prefix_hit_tokens"] >= 2 * t
        assert dec.metrics["prefix_hits"] == 1
        # The endpoints round-trip on their own too.
        tr = export_transfer(dc.prefill[0], prompt)
        assert tr.n_pages == 2 and tr.first_token == want[0]
        assert sorted(tr.order) == list(range(tr.n_pages))
        assert all(isinstance(a, np.ndarray) for pg in tr.payloads
                   for a in pg.values())
        assert import_transfer(dc.decode[0], tr) == 2 * t
    finally:
        dc.close()


def _cpu_spec(**kw):
    return EngineSpec(arch="llama3.2-1b", max_new_tokens=3, max_slots=1,
                      max_len=96, chip=(("smem_bytes", LEAF),),
                      device="cpu", **kw)


def test_spawned_replicas_match_the_single_engine():
    """Routed and disaggregated over the spawn transport: the workers
    rebuild the engine from the picklable spec, seeded, on the CPU."""
    spec = _cpu_spec()
    single = spec(0)
    cfg = single.cfg
    t = single.page.page_tokens
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32).tolist()
               for n in (2 * t + 3, 9, 13)]
    want = [single.generate([p], 3)[0] for p in prompts]
    plan = plan_decode(cfg, max_len=96, dtype_bytes=4,
                       spec=h100_spec(smem_bytes=LEAF), cluster=2)
    cluster = ServeCluster.from_plan(plan, spec, transport="proc")
    try:
        crs = [cluster.submit(p, 3) for p in prompts]
        assert [cr.result(timeout=300) for cr in crs] == want
        assert {cr.replica for cr in crs} == {0, 1}
        pids = {e["pid"] for e in cluster.trace_events() if e["ph"] != "M"}
        assert pids == {0, 1, 2}
    finally:
        cluster.close()
    dc = DisaggCluster.from_plan(plan, spec, split="1:1", transport="proc")
    try:
        assert dc.generate(prompts[0], 3) == want[0]
        dec = dc.decode[0]
        dec.submit("stats", None).wait(120)     # the generate's tick first
        assert dec.last_stats.metrics["prefix_hit_tokens"] >= 2 * t
    finally:
        dc.close()
    assert not any(r._worker.is_alive()
                   for r in cluster.replicas + dc.prefill + dc.decode)


def test_merged_trace_shows_two_replicas_and_the_router():
    spec = _cpu_spec()
    plan = plan_decode(spec.config(), max_len=96, dtype_bytes=4,
                       spec=h100_spec(smem_bytes=LEAF), cluster=2)
    cluster = ServeCluster.from_plan(plan, spec, transport="thread",
                                     policy="round_robin")
    try:
        cluster.generate([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], 2)
        events = cluster.trace_events()
        assert {e["pid"] for e in events if e["ph"] != "M"} == {0, 1, 2}
        names = {e["pid"]: e["args"]["name"] for e in events
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert names.get(2) == "router"
        assert [rep.engine.tracer.pid for rep in cluster.replicas] == [0, 1]
        assert 'repro_fleet_replicas{process="router"} 2' in \
            cluster.prometheus()
    finally:
        cluster.close()


def test_replicas_split_one_cards_kv_budget():
    spec = _cpu_spec()
    cfg = spec.config()
    plan = plan_decode(cfg, max_len=96, batch=1, dtype_bytes=4,
                       spec=h100_spec(smem_bytes=LEAF))
    whole = kv_budget(plan, cfg, 4)
    weights = cfg.param_count() * 4
    ctx = 3 << 20
    each = replica_kv_budget(spec, 2, ctx)
    assert each == (whole - weights - 2 * ctx) // 2
    assert replica_kv_budget(spec, 1, 0) == whole
    eng = dataclasses.replace(spec, kv_budget_bytes=each)(0)
    assert eng.budget_bytes == each
    assert eng.obs.value("budget_bytes") == each
    with pytest.raises(ValueError, match="do not fit"):
        replica_kv_budget(spec, 2, whole)


@pytest.mark.parametrize("args", [
    ["--cluster", "2", "--tokens", "4", "--batch", "3", "--prompt_len",
     "24"],
    ["--disagg", "1:1", "--tokens", "3", "--batch", "2", "--prompt_len",
     "40", "--smem_kib", "16", "--transport", "proc"],
])
def test_cluster_command_line_on_the_cpu(args, tmp_path):
    trace = tmp_path / "trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "llama3.2-1b", "--device", "cpu", "--trace", str(trace), *args]
    proc = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "replicas=2 (DCN np=2)" in out
    n_tok = 12 if args[0] == "--cluster" else 6
    assert f"[cluster] {n_tok} tokens in" in out
    if args[0] == "--cluster":
        assert "from pids [0, 1, 2]" in out and trace.exists()
    else:
        assert "role=prefill" in out and "role=decode" in out
