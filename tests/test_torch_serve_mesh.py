"""Serving over a device mesh: the port's ``plan_decode(cfg, mesh)``,
``kv_budget(mesh=)``, ``make_serve_steps``' cache sharding and
``ServeEngine(mesh=)`` against the JAX package's.

  * The decode plan on meshes (1, 1), (2, 2), (2, 4) and (16, 16), at a
    16 GiB and a 220 kB HBM, with the same leaf, equals the reference's:
    ``kv_shard``, the mesh level's ``np_raw``, ``page_tokens`` and the
    pool's pages; the KV budget equals the reference's ``_kv_budget``
    arithmetic.  (Both configs as registered: the TPU calibration
    artifact of the JAX package is pointed away.)
  * ``make_serve_steps``' ``cache_sharding`` equals the reference's
    PartitionSpecs on a (2, 2) mesh in every branch of its decision
    (``cache_policy`` auto, baseline and plan; heads that divide the model
    axis or not; the sequence-sharded case; long context; the two cases of
    ``tests/test_serve_plan_sharding.py``).
  * On 4 gloo ranks at (2, 2) (``launch.mesh.spawn_world``), the reduced
    llama (4 heads, 2 KV heads) served by ``ServeEngine(mesh=)`` gives the
    greedy tokens of the port's meshless engine and of the reference's
    engine on a (2, 2) host mesh (a subprocess with 4 forced host devices,
    run at the same time; its paged engine wrapped in
    ``test_torch_serve_moe._synchronous``), paged and cohort, at
    ``kv_shard`` 2 (the 220 kB HBM) and 1 (16 GiB); the pool's and the
    cohort cache's KV heads are halved on each rank exactly when
    ``kv_shard`` is 2.  The sequence-sharded cohort steps
    (``cache_seq_sharded=True``) give the reference's logits at 1e-5
    (float32), prefill and three decode steps.
  * The other families the mesh engine admits (mixtral paged and cohort;
    the cohort engine of qwen2-vl, whisper, deepseek-v2 and xlstm; the
    paged engine of xlstm and whisper; zamba2 paged and cohort) give the
    greedy tokens of the meshless engine and of the reference's engine on
    a (2, 2) host mesh, on the same 4-rank world shape and the same
    weights and prompts.  The paged engine's per-slot state buffers shard
    on each rank (their rows reached through local shards), zamba2's scan
    runs on local tensors, and a zamba2 slot that stalls under a
    three-page pool resumes on its saved state with the tokens of both
    engines.  Paged mla_moe and the prefix cache are refused with
    ``NotImplementedError``.
    zamba2's training forward on (2, 2) equals the reference's forward on
    a (2, 2) ``jax.sharding.Mesh`` and the meshless one at 2e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import torch_dist_workers as W
from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.serve.engine import plan_decode as ref_plan_decode
from repro.serve.kvcache import page_spec_from_plan as ref_page_spec
from repro_torch.configs import get_model_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import AbstractMesh
from repro_torch.hw import h100_spec
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine, ServePolicy
from repro_torch.serve.engine import kv_budget, plan_decode
from repro_torch.serve.steps import make_serve_steps
from repro_torch.tree import tree_flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF = 16 << 10
SMALL, BIG = 220_000, 16 << 30
MESHES = [(1, 1), (2, 2), (2, 4), (16, 16)]
LENS, NEWS = (8, 12, 8, 5), [6, 3, 2, 4]
CASES = [("paged", SMALL), ("cohort", SMALL), ("paged", BIG),
         ("cohort", BIG)]
TOL = dict(rtol=1e-5, atol=1e-5)

#: make_serve_steps cases on (2, 2): name -> (kv heads, heads, kind,
#: seq_len, keyword arguments; "plan" is a decode plan of that kv_shard).
SPEC_CASES = {
    "auto_heads": (2, 4, "decode", 64, {}),
    "auto_seq": (1, 4, "decode", 64, {}),
    "auto_prefill_no_divide": (1, 4, "prefill", 64, {}),
    "baseline": (2, 4, "decode", 64, {"cache_policy": "baseline"}),
    "baseline_seq": (2, 4, "decode", 64, {"cache_policy": "baseline",
                                          "cache_seq_sharded": True}),
    "head_flag_no_divide": (1, 4, "decode", 64,
                            {"cache_head_sharded": True}),
    "long_context": (2, 4, "decode", 262144, {"cache_policy": "baseline"}),
    "plan_sharded": (4, 4, "decode", 64, {"plan": 2}),
    "plan_replicated": (2, 4, "decode", 64, {"plan": 1}),
}

_REF = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[3])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from test_torch_serve_moe import _synchronous
    from repro.configs import get_model_config
    from repro.configs.base import ShapeConfig
    from repro.hw.tpu import chip_spec
    from repro.serve import ServeEngine, ServePolicy, make_serve_steps

    d = dict(np.load(sys.argv[1]))
    spec_cases = json.loads(sys.argv[2])
    tree = {}
    for k, v in d.items():
        if k.startswith("param/"):
            node = tree
            keys = k[len("param/"):].split("/")
            for kk in keys[:-1]:
                node = node.setdefault(kk, {})
            node[keys[-1]] = jnp.asarray(v)
    prompts = [d[f"prompt/{i}"] for i in range(
        sum(k.startswith("prompt/") for k in d))]
    news = [int(n) for n in d["news"]]
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    cfg = get_model_config("llama3.2-1b").reduced()
    out = {"engines": [], "specs": {}}
    for batching, hbm in [("paged", %(small)d), ("cohort", %(small)d),
                          ("paged", %(big)d), ("cohort", %(big)d)]:
        eng = ServeEngine(cfg, mesh, policy=ServePolicy(
            max_new_tokens=4, max_len=64, max_slots=4, batching=batching),
            params=tree, spec=chip_spec(vmem_bytes=%(leaf)d,
                                        vmem_reserved_bytes=0,
                                        hbm_bytes=hbm))
        if batching == "paged":
            eng = _synchronous(eng)
        toks = eng.generate(prompts, max_new_tokens=news)
        out["engines"].append({"tokens": toks,
                               "kv_shard": eng.plan.kv_shard(),
                               "budget": eng.scheduler.budget_bytes})

    prompt = jnp.asarray(d["seq/prompt"])
    shape = ShapeConfig("d", prompt.shape[1], prompt.shape[0], "decode")
    ss = make_serve_steps(cfg, shape, mesh, dtype=jnp.float32,
                          max_len_extra=8, cache_policy="baseline",
                          cache_seq_sharded=True)
    logits, cache = ss.prefill(tree, {"tokens": prompt})
    rows = [np.asarray(logits)]
    for _ in range(3):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = ss.decode(tree, cache, {"tokens": tok})
        rows.append(np.asarray(logits))
    out["seq_logits"] = np.stack(rows).tolist()

    class _Plan:
        def __init__(self, kv):
            self.kv = kv
        def kv_shard(self):
            return self.kv

    for name, (kv, h, kind, seq, kw) in spec_cases.items():
        c = dataclasses.replace(cfg, n_kv_heads=kv, n_heads=h)
        kw = dict(kw)
        if "plan" in kw:
            kw["decode_plan"] = _Plan(kw.pop("plan"))
        s = make_serve_steps(c, ShapeConfig("s", seq, 4, kind), mesh,
                             dtype=jnp.float32, max_len_extra=8, **kw)
        out["specs"][name] = jax.tree.map(
            lambda ns: [list(e) if isinstance(e, tuple) else e
                        for e in ns.spec], s.cache_sharding,
            is_leaf=lambda x: hasattr(x, "spec"))
    print(json.dumps(out))
""") % {"small": SMALL, "big": BIG, "leaf": LEAF}


class _Plan:
    """A decode plan as ``make_serve_steps`` reads it: its ``kv_shard``."""

    def __init__(self, kv: int):
        self.kv = kv

    def kv_shard(self) -> int:
        return self.kv


@pytest.fixture(autouse=True)
def _registered_configs(monkeypatch, tmp_path):
    """Both packages' configs as registered, and analytic pages."""
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "none.json"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "none.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNING", str(tmp_path / "none.json"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's and the reference's results on the same inputs,
    computed at the same time, and the meshless engine's tokens."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    cfg = get_model_config("llama3.2-1b").reduced()
    params = Model(cfg).init(0, "cpu", torch.float32)
    flat = {"param/" + k.replace(".", "/"): v.numpy()
            for k, v in tree_flatten_with_paths(params).items()}
    rng = np.random.default_rng(0)
    for i, n in enumerate(LENS):
        flat[f"prompt/{i}"] = rng.integers(0, cfg.vocab_size, n,
                                           dtype=np.int32)
    flat["news"] = np.array(NEWS)
    flat["seq/prompt"] = rng.integers(0, cfg.vocab_size, (2, 6),
                                      dtype=np.int32)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **flat)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "REPRO_CALIBRATION": str(tmp / "none.json")}
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF, inputs, json.dumps(SPEC_CASES),
         os.path.join(REPO, "tests")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = spawn_world(
            W.serve_mesh_world, 4, str(tmp / "store"),
            args=(inputs, [(b, hbm, LEAF, 4, 64, "float32")
                           for b, hbm in CASES]), timeout_s=400)
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    prompts = [flat[f"prompt/{i}"] for i in range(len(LENS))]
    meshless = []
    for batching, hbm in CASES:
        eng = ServeEngine(cfg, ServePolicy(max_new_tokens=4, max_len=64,
                                           max_slots=4, batching=batching),
                          params=params, device="cpu",
                          spec=h100_spec(smem_bytes=LEAF, hbm_bytes=hbm))
        meshless.append(eng.generate(prompts, max_new_tokens=NEWS))
    return ranks, ref, meshless


def _ref_mesh(d: int, m: int):
    return types.SimpleNamespace(shape={"data": d, "model": m})


@pytest.mark.parametrize("hbm", [BIG, SMALL])
@pytest.mark.parametrize("mesh", MESHES)
def test_plan_decode_on_mesh_matches_reference(mesh, hbm):
    d, m = mesh
    cfg = get_model_config("llama3.2-1b").reduced()
    rcfg = ref_config("llama3.2-1b").reduced()
    mine = plan_decode(cfg, AbstractMesh(mesh, ("data", "model")),
                       max_len=64, batch=4, dtype_bytes=4,
                       spec=h100_spec(smem_bytes=LEAF, hbm_bytes=hbm))
    ref = ref_plan_decode(rcfg, _ref_mesh(d, m), max_len=64, batch=4,
                          dtype_bytes=4,
                          spec=chip_spec(vmem_bytes=LEAF,
                                         vmem_reserved_bytes=0,
                                         hbm_bytes=hbm))
    assert mine.kv_shard() == ref.kv_shard()
    lp, rp = mine.level("NVLINK"), ref.level("ICI")
    assert lp.np_raw == rp.np_raw and lp.budget_bytes == rp.budget_bytes
    assert mine.page_plan()["page_tokens"] == ref.page_plan()["page_tokens"]
    assert mine.page_table()["pages_total"] == \
        ref.page_table()["pages_total"]
    # The reference engine's _kv_budget arithmetic on its own plan.
    n_dev, data_n = d * m, d
    hbm_total = rp.budget_bytes * n_dev
    weights = rcfg.param_count() * 4 * data_n
    repl = max(1, m // max(1, ref.kv_shard()))
    ref_budget = max(ref_page_spec(ref, rcfg, 4).page_bytes,
                     int(0.8 * max(0, hbm_total - weights) / repl))
    mesh_obj = AbstractMesh(mesh, ("data", "model"))
    assert kv_budget(mine, cfg, 4, 0.8, mesh=mesh_obj) == ref_budget


def test_meshless_plan_and_budget_unchanged():
    """``mesh=None`` is the one-card walk and budget of the meshless
    engine."""
    cfg = get_model_config("llama3.2-1b")
    a = plan_decode(cfg, max_len=4096, batch=8)
    b = plan_decode(cfg, AbstractMesh((1, 1), ("data", "model")),
                    max_len=4096, batch=8)
    assert a.describe() == b.describe()
    assert kv_budget(a, cfg, 2) == kv_budget(b, cfg, 2,
                                             mesh=AbstractMesh(
                                                 (1, 1), ("data", "model")))


def test_cache_sharding_matches_reference(world):
    _, ref, _ = world
    cfg = get_model_config("llama3.2-1b").reduced()
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for name, (kv, h, kind, seq, kw) in SPEC_CASES.items():
        c = dataclasses.replace(cfg, n_kv_heads=kv, n_heads=h)
        kw = dict(kw)
        if "plan" in kw:
            kw["decode_plan"] = _Plan(kw.pop("plan"))
        ss = make_serve_steps(c, ShapeConfig("s", seq, 4, kind), mesh,
                              dtype=torch.float32, max_len_extra=8, **kw)
        mine = json.loads(json.dumps(ss.cache_sharding))
        assert mine == ref["specs"][name], name
    # The two cases of test_serve_plan_sharding on (2, 2): the plan's
    # head sharding, and replicated heads with no sequence fallback.
    assert ref["specs"]["plan_sharded"]["layers"]["k"][3] == "model"
    assert ref["specs"]["plan_sharded"]["layers"]["k"][2] is None
    assert ref["specs"]["plan_replicated"]["layers"]["k"][2:4] == [None,
                                                                   None]


def test_engine_on_mesh_matches_meshless_and_reference(world):
    ranks, ref, meshless = world
    for rank in ranks:
        for i, (batching, hbm) in enumerate(CASES):
            got = rank[i]
            assert got["tokens"] == meshless[i], (batching, hbm)
            assert got["tokens"] == ref["engines"][i]["tokens"]
            assert got["kv_shard"] == ref["engines"][i]["kv_shard"]
            assert got["budget"] == ref["engines"][i]["budget"]
            want = 2 if hbm == SMALL else 1
            assert got["kv_shard"] == want
            # 2 KV heads: one a rank exactly when the plan shards them.
            assert got["local_kv_heads"] == (1 if want == 2 else 2)


def test_seq_sharded_steps_match_reference(world):
    ranks, ref, _ = world
    want = np.asarray(ref["seq_logits"], dtype=np.float32)
    for rank in ranks:
        seq = rank[-1]
        np.testing.assert_allclose(seq["logits"], want, **TOL)
        assert seq["local_seq"] == (6 + 8) // 2
        # The cache's batch over "data", its sequence over "model".
        assert seq["spec"] == [str(Shard(1)), str(Shard(2))]


#: The other families ``ServeEngine.MESH_FAMILIES`` admits on a mesh.
FAMILY_CASES = [("mixtral-8x7b", "paged"), ("mixtral-8x7b", "cohort"),
                ("qwen2-vl-7b", "cohort"), ("whisper-large-v3", "cohort"),
                ("deepseek-v2-236b", "cohort"), ("xlstm-1.3b", "cohort"),
                ("xlstm-1.3b", "paged"), ("whisper-large-v3", "paged"),
                ("zamba2-1.2b", "cohort"), ("zamba2-1.2b", "paged")]
#: The cases whose per-slot state rows (or whose Mamba2 scan) a mesh
#: reaches through local shards.
STATE_CASES = FAMILY_CASES[-4:]
HYBRID = "zamba2-1.2b"
HYBRID_BATCHES = (1, 2)
#: zamba2 paged under a pool of three 16-token pages (16 KiB of shared
#: memory plans 16-token pages on (2, 2) and in the reference alike): the
#: younger slot stalls, riding through decode ticks with its Mamba2 state
#: saved and restored around each, and resumes when the older one ends
#: (``tests/test_torch_serve_hybrid.py``'s resuming trace).
STALL = {"key": "stall", "max_len": 64, "max_slots": 2,
         "kv_budget_bytes": 3 * 16 * 1024, "smem": LEAF, "news": [12, 24]}
STALL_CASE = (HYBRID, "paged", STALL)

_REF_FAMILIES = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[4])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from test_torch_serve_moe import _synchronous
    from repro.configs import get_model_config
    from repro.dist.sharding import (arch_rules, param_shardings,
                                     use_mesh_rules, with_batch_guard)
    from repro.hw.tpu import chip_spec
    from repro.models.model import build_model
    from repro.serve import ServeEngine, ServePolicy

    d = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[2])
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))

    def nested(pre):
        out = {}
        for key, v in d.items():
            if key.startswith(pre):
                node = out
                *path, leaf = key[len(pre):].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(v)
        return out

    def host_decode_batch(eng):
        # The cohort engine derives vlm's decode positions from its cache,
        # committed replicated, which jax 0.9.0's jit refuses against the
        # data-sharded in_sharding; as host arrays jit places them.
        make = eng._steps
        def steps(*args, **kw):
            ss = make(*args, **kw)
            dec = ss.decode
            return dataclasses.replace(ss, decode=lambda p, c, b: dec(
                p, c, jax.tree.map(np.asarray, b)))
        eng._steps = steps
        return eng

    def placed_cache(eng):
        # The paged enc_dec engine installs the encoder's cross K/V as the
        # encoder left them (heads over "model"), which its jitted steps
        # refuse against their replicated in_sharding; placed first, jit
        # takes them.
        make = eng._paged_steps
        def steps(*args, **kw):
            ss = make(*args, **kw)
            def placed(step):
                return lambda p, c, *a: step(
                    p, jax.device_put(c, ss.cache_sharding), *a)
            return dataclasses.replace(
                ss, decode=placed(ss.decode),
                prefill_chunk=placed(ss.prefill_chunk))
        eng._paged_steps = steps
        return eng

    out = {"tokens": [], "stalls": []}
    for case in cases:
        arch, batching = case[:2]
        opts = case[2] if len(case) > 2 else {}
        key = opts.get("key", arch)
        cfg = get_model_config(arch).reduced()
        n = len({k.split("/")[2] for k in d
                 if k.startswith(key + "/prompt/")})
        prompts = [{k.split("/")[3]: v for k, v in d.items()
                    if k.startswith(f"{key}/prompt/{i}/")}
                   for i in range(n)]
        prompts = [p["tokens"] if list(p) == ["tokens"] else p
                   for p in prompts]
        spec = (chip_spec(vmem_bytes=opts["smem"], vmem_reserved_bytes=0)
                if "smem" in opts else None)
        eng = ServeEngine(cfg, mesh, policy=ServePolicy(
            max_new_tokens=4, max_len=opts.get("max_len", 64),
            max_slots=opts.get("max_slots", 4), batching=batching,
            kv_budget_bytes=opts.get("kv_budget_bytes")),
            params=nested(arch + "/p/"), spec=spec)
        eng = _synchronous(placed_cache(eng)) if batching == "paged" \
            else host_decode_batch(eng)
        out["tokens"].append(eng.generate(prompts,
                                          max_new_tokens=opts.get("news")))
        out["stalls"].append(eng.metrics["stalls"])

    arch = sys.argv[3]
    cfg = get_model_config(arch).reduced()
    model = build_model(cfg, remat="none")
    for b in json.loads(sys.argv[5]):
        tok = jnp.asarray(d[f"{arch}/forward/{b}"])
        rules = with_batch_guard(arch_rules(cfg, mesh), mesh, b)
        def fwd(p, t):
            with use_mesh_rules(mesh, rules):
                return model.forward(p, {"tokens": t, "labels": t},
                                     dtype=jnp.float32)[0]
        logits = jax.jit(fwd, in_shardings=(
            param_shardings(mesh, rules, model.param_specs()),
            NamedSharding(mesh, rules.act_spec(("batch", "seq")))))(
                nested(arch + "/p/"), tok)
        out[f"forward/{b}"] = np.asarray(logits).tolist()
    print(json.dumps(out))
""")


def _family_prompts(arch: str) -> list:
    cfg = get_model_config(arch).reduced()
    rng = np.random.default_rng(1)
    if cfg.family == "enc_dec":
        return [{"enc_embeds": (0.02 * rng.standard_normal(
                    (n, cfg.d_model))).astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab_size, 4,
                                        dtype=np.int32)} for n in (8, 12)]
    if cfg.family == "vlm":
        # The reference's mesh steps take vlm prompts as embeddings.
        return [{"embeds": (0.02 * rng.standard_normal(
                    (n, cfg.d_model))).astype(np.float32),
                 "positions_3d": np.broadcast_to(
                     np.arange(n, dtype=np.int32), (3, n)).copy()}
                for n in (8, 12, 8)]
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in (8, 12, 8, 5)]


def _stall_prompts() -> list:
    cfg = get_model_config(HYBRID).reduced()
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
            for _ in range(2)]


def _hybrid_tokens(batch: int) -> np.ndarray:
    cfg = get_model_config(HYBRID).reduced()
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (batch, 12))


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """The other families served on the 4-rank world and by the
    reference's engine on a (2, 2) host mesh, at the same time, on the
    same seeded weights (``Model.init(0)``) and prompts; and the
    reference's zamba2 forward on that mesh."""
    tmp = tmp_path_factory.mktemp("serve_mesh_families")
    prompts = {arch: _family_prompts(arch) for arch, _ in FAMILY_CASES}
    prompts["stall"] = _stall_prompts()
    cases = FAMILY_CASES + [STALL_CASE]
    flat = {}
    for arch in dict.fromkeys(arch for arch, _ in FAMILY_CASES):
        cfg = get_model_config(arch).reduced()
        for k, v in tree_flatten_with_paths(
                Model(cfg).init(0, "cpu", torch.float32)).items():
            flat[f"{arch}/p/" + k.replace(".", "/")] = v.numpy()
    for arch, ps in prompts.items():
        for i, p in enumerate(ps):
            for k, v in (p.items() if isinstance(p, dict)
                         else [("tokens", p)]):
                flat[f"{arch}/prompt/{i}/{k}"] = v
    for b in HYBRID_BATCHES:
        flat[f"{HYBRID}/forward/{b}"] = _hybrid_tokens(b).astype(np.int32)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **flat)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "REPRO_CALIBRATION": str(tmp / "none.json")}
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_FAMILIES, inputs,
         json.dumps(cases), HYBRID, os.path.join(REPO, "tests"),
         json.dumps(HYBRID_BATCHES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = spawn_world(W.serve_families_world, 4,
                            str(tmp / "store"), args=(cases, prompts),
                            timeout_s=400)
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return prompts, ranks, json.loads(out.strip().splitlines()[-1])


def test_other_families_on_mesh_match_meshless(families):
    """moe (mixtral: its window and expert dispatch), paged and cohort, the
    cohort engine of vlm, enc_dec, mla_moe and xlstm, the paged engine of
    xlstm and enc_dec, and hybrid_ssm paged and cohort on 4 gloo ranks at
    (2, 2): the greedy tokens of the meshless engine and of the
    reference's engine on a (2, 2) host mesh, on the same seeded
    weights."""
    prompts, ranks, ref = families
    for i, (arch, batching) in enumerate(FAMILY_CASES):
        cfg = get_model_config(arch).reduced()
        want = ServeEngine(cfg, ServePolicy(max_new_tokens=4, max_len=64,
                                            max_slots=4, batching=batching),
                           params=Model(cfg).init(0, "cpu", torch.float32),
                           device="cpu").generate(prompts[arch])
        assert want == ref["tokens"][i], (arch, batching)
        for rank in ranks:
            assert rank[i]["tokens"] == want, (arch, batching)


@pytest.mark.parametrize("case", STATE_CASES,
                         ids=["-".join(c) for c in STATE_CASES])
def test_state_rows_and_scan_on_local_shards(families, case):
    """The new mesh cases reach their state through local shards: the
    paged engine's recurrent state buffers shard their slots over "data"
    (and enc_dec's cross K/V stay whole, as its plan's ``kv_shard`` of 1
    lays them out), so the admission reset, the chunks' rows and the
    frozen slots' save and restore wrote each rank's own shard; zamba2's
    scan ran on local tensors only, and its one-token step was handed on
    from DTensors to local ones."""
    _, ranks, _ = families
    i = FAMILY_CASES.index(case)
    arch, batching = case
    for rank in ranks:
        got = rank[i]
        if batching == "paged":
            assert got["state"]
            for k, (g, l) in got["state"].items():
                if arch == "whisper-large-v3":
                    assert l == g, (k, g, l)
                else:
                    assert l[1] == g[1] // 2, (k, g, l)   # slots over data
        if arch == HYBRID:
            calls = got["calls"]
            assert calls.get("scan/local", 0) >= 1
            assert calls.get("scan/dtensor", 0) == 0
            assert calls.get("step/local", 0) >= \
                calls.get("step/dtensor", 0) >= 1


def test_stalled_hybrid_slot_on_mesh(families):
    """zamba2 paged under a three-page pool on (2, 2): the younger slot
    stalls, its Mamba2 state rows saved and restored through the local
    shards around each tick it rides through, and the greedy tokens equal
    the meshless engine's under the same pool, the unconstrained
    engine's, and the reference's engine on a (2, 2) host mesh."""
    prompts, ranks, ref = families
    cfg = get_model_config(HYBRID).reduced()
    params = Model(cfg).init(0, "cpu", torch.float32)
    spec = h100_spec(smem_bytes=LEAF)
    news = STALL["news"]

    def engine(budget):
        return ServeEngine(cfg, ServePolicy(
            max_new_tokens=4, max_len=STALL["max_len"],
            max_slots=STALL["max_slots"], batching="paged",
            kv_budget_bytes=budget), params=params, spec=spec,
            device="cpu")

    tight = engine(STALL["kv_budget_bytes"])
    want = tight.generate(prompts["stall"], max_new_tokens=news)
    assert tight.metrics["stalls"] >= 1
    assert engine(None).generate(prompts["stall"],
                                 max_new_tokens=news) == want
    assert ref["tokens"][-1] == want and ref["stalls"][-1] >= 1
    for rank in ranks:
        assert rank[-1]["tokens"] == want
        assert rank[-1]["stalls"] >= 1


@pytest.mark.parametrize("batch", HYBRID_BATCHES)
def test_hybrid_forward_with_replicated_batch(families, tmp_path, batch):
    """zamba2's forward on (2, 2) equals the reference's forward on a
    (2, 2) host mesh and the meshless one at 2e-4 (the mesh forward tests'
    tolerance: the packages and DTensor sum in other orders) whether the
    batch shards over "data" (2) or runs replicated over it (1: the
    mixer's input then arrives as a partial sum over "model", which
    DTensor's einsum of B by C got wrong until the mixer reduced it)."""
    cfg = get_model_config(HYBRID).reduced()
    tokens = _hybrid_tokens(batch)
    got = spawn_world(W.forward_world, 4, str(tmp_path / "store"),
                      args=(HYBRID, tokens), timeout_s=300)
    model = Model(cfg, remat="none")
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        want, _ = model.forward(model.init(0, "cpu", torch.float32),
                                {"tokens": t, "labels": t}, torch.float32)
    ref = np.asarray(families[2][f"forward/{batch}"], dtype=np.float32)
    np.testing.assert_allclose(want.numpy(), ref, rtol=2e-4, atol=2e-4)
    for logits in got:
        np.testing.assert_allclose(logits, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(logits, want.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_mesh_engine_refuses_what_it_does_not_serve():
    """Still refused on a mesh: paged mla_moe (its latent pool) and the
    radix prefix cache."""
    mesh = AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="mla_moe"):
        ServeEngine(get_model_config("deepseek-v2-236b").reduced(),
                    ServePolicy(batching="paged"), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="prefix"):
        ServeEngine(get_model_config("llama3.2-1b").reduced(),
                    ServePolicy(prefix_cache="radix"), device="cpu",
                    mesh=mesh)
