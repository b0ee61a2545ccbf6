"""Rank functions for the port's multi-rank CPU tests (no jax here: each
spawned rank imports this module, and only the port).

``launch.mesh.spawn_world`` runs one of these on every rank of a gloo
world; each returns numpy arrays (whole values, gathered from DTensors),
which the test compares against the JAX package's results computed in a
separate process on the same inputs.
"""

import numpy as np
import torch


def _np(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy().copy()


def nested(flat: dict) -> dict:
    """``{"a/b/c": array}`` -> ``{"a": {"b": {"c": array}}}``."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _grads(fn, args, seeds):
    """Outputs of ``fn(*args)`` (DTensors) and the gradients of
    ``sum_i <y_i, seed_i>`` w.r.t. ``args``, all as numpy."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ys = fn(*leaves)
    ys = list(ys) if isinstance(ys, (list, tuple)) else [ys]
    total = sum((y.full_tensor() * torch.from_numpy(s)).sum()
                for y, s in zip(ys, seeds))
    total.backward()
    return [_np(y) for y in ys], [_np(a.grad) for a in leaves]


# ---------------------------------------------------------------------------
# The rings and the pipeline
# ---------------------------------------------------------------------------


def ring_world(rank: int, inputs: str) -> dict:
    """Every ring in both modes on a 4-way ``model`` axis (forward and
    gradients), the rings with the batch sharded on a (2, 2) mesh, and the
    GPipe pipeline on a 4-stage ``pod`` axis."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.overlap import (make_ag_matmul, make_ag_matmul_fused,
                                          make_rs_matmul)
    from repro_torch.dist.pipeline import make_pipeline

    torch.set_num_threads(1)
    d = _load(inputs)
    x, w, w2 = d["x"], d["w"], d["w2"]
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    out = {}
    for mode in ("ring", "serpentine"):
        for name, make, args, seeds in (
                ("ag", make_ag_matmul, (x, w), (d["gy"],)),
                ("rs", make_rs_matmul, (x, w), (d["gy"],)),
                ("agf", lambda m, a, mo: make_ag_matmul_fused(m, a, mo, 2),
                 (x, w, w2), (d["gy"], d["gy2"]))):
            fn = make(mesh, "model", mode)
            ys, gs = _grads(fn, args, seeds)
            for i, y in enumerate(ys):
                out[f"{name}/{mode}/y{i}"] = y
            for i, g in enumerate(gs):
                out[f"{name}/{mode}/g{i}"] = g
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for mode in ("ring", "serpentine"):
        for name, make in (("ag", make_ag_matmul), ("rs", make_rs_matmul)):
            fn = make(mesh22, "model", mode, batch_axes=("data",))
            ys, gs = _grads(fn, (x, w), (d["gy"],))
            out[f"{name}/{mode}/batch/y0"] = ys[0]
            for i, g in enumerate(gs):
                out[f"{name}/{mode}/batch/g{i}"] = g
    pod = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    pipe = make_pipeline(
        pod, lambda p, h: torch.tanh(h @ p["w"]), axis="pod")
    out["pipeline"] = _np(pipe({"w": torch.from_numpy(d["stages"])},
                               torch.from_numpy(d["mbs"])))
    return out


# ---------------------------------------------------------------------------
# The model and the sharded train step
# ---------------------------------------------------------------------------


#: Reduced configs beyond the registry's: reduced xlstm-1.3b at 2 heads,
#: whose state splits its key dim ("state_inner") on a model axis of 4.
VARIANTS = {"xlstm-1.3b-2h": ("xlstm-1.3b", {"n_heads": 2,
                                             "n_kv_heads": 2})}


def _cfg(arch: str = "llama3.2-1b"):
    """``arch``'s reduced config, or a ``VARIANTS`` entry's."""
    import dataclasses

    from repro_torch.configs import get_model_config

    base, over = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(get_model_config(base).reduced(), **over)


def loop_world(rank: int, ckpt_dir: str) -> dict:
    """40 serpentine steps on (2, 2), a (4, 1) ``Trainer``'s checkpoint
    restored by a (2, 2) one, a preemption that reaches one rank, and a
    restore refused when the ranks see different checkpoints."""
    import dataclasses
    import shutil

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import RunConfig, ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.trainer import (Trainer, init_train_state,
                                            make_train_step)
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_flatten_with_paths

    torch.set_num_threads(1)
    cfg = _cfg()
    out = {}
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    # 40 steps on (2, 2), the reference's mesh test: the loss falls.
    shape8 = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")
    train8 = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                         remat="none", collectives="serpentine")
    ts8 = make_train_step(cfg, shape8, mesh22, train8)
    p8, o8 = init_train_state(ts8, 0, train8)
    # The sharded init holds the one-device init's values, and each rank's
    # local tensor owns its shard alone (the whole leaf was let go).
    whole = tree_flatten_with_paths(Model(cfg).init(0, device="cpu"))
    mine = tree_flatten_with_paths(p8)
    out["init/err"] = np.array(max(
        float(np.abs(_np(mine[k]) - v.numpy()).max()) for k, v in whole.items()))
    locs = [t.to_local() for t in mine.values()]
    out["init/owned"] = np.array(all(
        t.untyped_storage().nbytes() == t.numel() * t.element_size()
        for t in locs))
    out["init/sharded"] = np.array(sum(
        t.numel() < mine[k].numel() for k, t in zip(mine, locs)))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
    losses = []
    for step in range(40):
        p8, o8, m8 = ts8.fn(p8, o8, ts8.place_batch(ds.batch(step % 4, 8)))
        losses.append(float(m8["loss"]))
    out["losses"] = np.array(losses)

    # Elastic restore: a (4, 1) run's checkpoint onto (2, 2).
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    run = RunConfig(model=cfg, shape=shape8, train=TrainConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=60, remat="none",
        checkpoint_dir=ckpt_dir, checkpoint_every=2))
    first = Trainer(run, mesh41)
    try:
        first.init_or_restore()
        first.fit(2, ((i, ds.batch(i, 8)) for i in range(2)), log_every=0)
        saved = {k: _np(v) for k, v in
                 tree_flatten_with_paths((first.params, first.opt)).items()}
    finally:
        first.preempt.uninstall()
    dist.barrier()
    second = Trainer(run, mesh22)
    try:
        out["restore/step"] = np.array(second.init_or_restore())
        got = tree_flatten_with_paths((second.params, second.opt))
        out["restore/err"] = np.array(max(
            float(np.abs(_np(got[k]) - v).max()) for k, v in saved.items()))
        out["restore/placements"] = np.array(
            str(got["0/layers/attn/wq"].placements))
    finally:
        second.preempt.uninstall()

    # A preemption that reaches rank 1 alone, during the 4th step: every
    # rank stops after it, and the final checkpoint is on disk when ``fit``
    # returns.
    def batches(trainer):
        for i in range(8):
            if i == 3 and rank == 1:
                trainer.preempt.request_stop()
            yield i, ds.batch(i, 8)

    run3 = dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_dir=ckpt_dir + "_preempt",
        checkpoint_every=100))
    third = Trainer(run3, mesh22)
    try:
        third.init_or_restore()
        third.fit(8, batches(third), log_every=0)
        out["preempt/step"] = np.array(third.step)
        out["preempt/saved"] = np.array(
            third.ckpt.latest_manifest()["step"])
    finally:
        third.preempt.uninstall()

    # Ranks that see different checkpoints (rank 0 alone sees one): every
    # rank refuses to restore.
    own = f"{ckpt_dir}_rank{rank}"
    if rank == 0:
        shutil.copytree(ckpt_dir + "_preempt", own)
    run4 = dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_dir=own))
    fourth = Trainer(run4, mesh22)
    try:
        fourth.init_or_restore()
        out["disagree/error"] = np.array("")
    except RuntimeError as e:
        out["disagree/error"] = np.array(str(e))
    finally:
        fourth.preempt.uninstall()
    return out


def _step(d: dict, arch: str, ts, cfg) -> dict:
    """One ``ts`` step from ``arch``'s parameters and batch in ``d`` and
    ``adamw_init``'s state; the new state and metrics, gathered."""
    from repro_torch.launch.trainer import distribute
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten_with_paths, tree_map

    params = params_from_numpy(_sub(d, f"{arch}/p/"), cfg, "cpu")
    params = tree_map(lambda p, pl: distribute(p, ts.mesh, pl).requires_grad_(
        True), params, ts.param_sharding)
    batch = ts.place_batch(_sub(d, f"{arch}/bt/"))
    new_p, new_o, metrics = ts.fn(params, adamw_init(params), batch)
    out = {}
    for name, tree in (("p", new_p), ("mu", new_o.mu), ("nu", new_o.nu)):
        for k, v in tree_flatten_with_paths(tree).items():
            out[f"{name}/{k}"] = _np(v)
    for k in ("loss", "grad_norm", "lr", "nll", "aux"):
        out[f"m/{k}"] = _np(metrics[k])
    out["fsdp"] = np.array(ts.rules.meta["fsdp"])
    out["collectives"] = np.array(ts.rules.meta.get("collectives", "gspmd"))
    return out


def _sub(d: dict, pre: str) -> dict:
    """The entries of ``d`` under ``pre``, nested by their paths."""
    return nested({k[len(pre):]: v for k, v in d.items() if k.startswith(pre)})


def family_world(rank: int, inputs: str, spec: str) -> dict:
    """For each arch of ``spec["archs"]``, from its parameters and batch in
    ``inputs``: the training forward under gspmd, ring and serpentine rules
    on a (1, 4) mesh and one step on (2, 2); then, if ``spec["fsdp"]`` is
    given, one step of its arch on (2, 2) under rules planned against an
    HBM of ``spec["fsdp"]["hbm"]`` bytes (FSDP, and so the serpentine rings
    under ``collectives="auto"``)."""
    import json

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.dist.sharding import (arch_rules, use_mesh_rules,
                                           with_collectives)
    from repro_torch.hw.h100 import h100_spec
    from repro_torch.launch.trainer import distribute, make_train_step
    from repro_torch.models.params import params_from_numpy
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    spec = json.loads(spec)
    d = _load(inputs)
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    shape = ShapeConfig("tiny", seq_len=spec["seq_len"],
                        global_batch=spec["batch"], kind="train")
    train = TrainConfig(dtype="float32", remat="none", warmup_steps=2,
                        total_steps=10)
    out = {}
    for arch in spec["archs"]:
        cfg = _cfg(arch)
        ts14 = make_train_step(cfg, shape, mesh14, train)
        params = tree_map(lambda p, pl: distribute(p, mesh14, pl),
                          params_from_numpy(_sub(d, f"{arch}/p/"), cfg, "cpu"),
                          ts14.param_sharding)
        batch = ts14.place_batch(_sub(d, f"{arch}/bt/"))
        for mode in ("gspmd", "ring", "serpentine"):
            rules = with_collectives(ts14.rules, mode)
            with torch.no_grad(), use_mesh_rules(mesh14, rules), \
                    implicit_replication():
                logits, aux = ts14.model.forward(params, batch,
                                                 dtype=torch.float32)
            out[f"{arch}/forward/{mode}"] = _np(logits)
            out[f"{arch}/aux/{mode}"] = _np(aux)
        ts22 = make_train_step(cfg, shape, mesh22, train)
        for k, v in _step(d, arch, ts22, cfg).items():
            out[f"{arch}/step/{k}"] = v
    if spec["fsdp"] is None:
        return out
    arch, hbm = spec["fsdp"]["arch"], spec["fsdp"]["hbm"]
    cfg = _cfg(arch)
    auto = TrainConfig(dtype="float32", remat="none", warmup_steps=2,
                       total_steps=10, collectives="auto")
    rules = arch_rules(cfg, mesh22, hierarchy=h100_spec(
        hbm_bytes=hbm).hierarchy(mesh_devices=4))
    ts = make_train_step(cfg, shape, mesh22, auto, rules=rules)
    for k, v in _step(d, arch, ts, cfg).items():
        out[f"fsdp/step/{k}"] = v
    out["fsdp/embed_placements"] = np.array(
        str(ts.param_sharding["embedding"]))
    return out


# ---------------------------------------------------------------------------
# Serving over a mesh
# ---------------------------------------------------------------------------


def serve_mesh_world(rank: int, inputs: str, cases: list) -> list:
    """The reduced llama served by ``ServeEngine(mesh=)`` on a (2, 2) CPU
    mesh, once a case: ``(batching, hbm_bytes, leaf_bytes, max_slots,
    max_len, dtype)``.  The parameters and prompts come from ``inputs``
    (``param/<path>`` and ``prompt/<i>`` arrays, ``news``); each case
    returns its greedy tokens, the plan's ``kv_shard`` and the pool's (or
    cache's) placements as strings."""
    from repro_torch.configs import get_model_config
    from repro_torch.hw import h100_spec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import params_from_numpy
    from repro_torch.serve import ServeEngine, ServePolicy

    d = _load(inputs)
    cfg = get_model_config("llama3.2-1b").reduced()
    tree = nested({k[len("param/"):]: v for k, v in d.items()
                   if k.startswith("param/")})
    prompts = [d[f"prompt/{i}"] for i in range(
        sum(k.startswith("prompt/") for k in d))]
    news = [int(n) for n in d["news"]]
    mesh = make_host_mesh(model_axis=2, device="cpu")
    out = []
    for batching, hbm, leaf, slots, max_len, dtype in cases:
        params = params_from_numpy(tree, cfg, "cpu")
        eng = ServeEngine(
            cfg, ServePolicy(max_new_tokens=4, max_len=max_len,
                             max_slots=slots, batching=batching),
            params=params, dtype=getattr(torch, dtype),
            spec=h100_spec(smem_bytes=leaf, hbm_bytes=hbm), device="cpu",
            mesh=mesh)
        toks = eng.generate(prompts, max_new_tokens=news)
        out.append({"tokens": toks, "kv_shard": eng.plan.kv_shard(),
                    "budget": eng.budget_bytes,
                    "page_tokens": eng.page.page_tokens,
                    "local_kv_heads": _local_kv_heads(eng, batching)})
    out.append(_seq_sharded_steps(tree, d, mesh))
    return out


def _local_kv_heads(eng, batching: str) -> int:
    """The KV heads one rank holds of the cache the engine's steps place:
    the pool's (paged) or a cohort cache's."""
    from repro_torch.serve.pages import init_paged_cache

    if batching == "paged":
        steps = eng._paged_steps(eng.policy.max_slots)
        cache = steps.place_cache(init_paged_cache(
            eng.cfg, eng.policy.max_slots, 2, eng.page.page_tokens, 1,
            eng.dtype, "cpu"))
        return int(cache["pool"]["k"].to_local().shape[3])
    steps = next(iter(eng._steps_cache.values()))
    cache = steps.place_cache(steps.model.init_cache(2, 8, eng.dtype,
                                                     device="cpu"))
    return int(cache["layers"]["k"].to_local().shape[3])


def _seq_sharded_steps(tree: dict, d: dict, mesh) -> dict:
    """``make_serve_steps(cache_seq_sharded=True)``: the cohort cache's
    sequence dim over "model" and the one-token query through
    ``attention_op``'s ``kv_seq`` branch; prefill of ``seq/prompt`` and
    three greedy decode steps, float32.  Returns the four logits rows."""
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.params import params_from_numpy
    from repro_torch.serve.steps import make_serve_steps

    cfg = get_model_config("llama3.2-1b").reduced()
    prompt = torch.from_numpy(d["seq/prompt"].astype(np.int64))
    shape = ShapeConfig("d", prompt.shape[1], prompt.shape[0], "decode")
    ss = make_serve_steps(cfg, shape, mesh, dtype=torch.float32,
                          max_len_extra=8, cache_policy="baseline",
                          cache_seq_sharded=True)
    params = ss.place_params(params_from_numpy(tree, cfg, "cpu"))
    logits, cache = ss.prefill(params, {"tokens": prompt})
    rows = [_np(logits)]
    for _ in range(3):
        tok = logits.argmax(-1)[:, None]
        logits, cache = ss.decode(params, cache, {"tokens": tok})
        rows.append(_np(logits))
    k = cache["layers"]["k"]
    return {"logits": np.stack(rows), "spec": list(map(str, k.placements)),
            "local_seq": int(k.to_local().shape[2])}


def serve_families_world(rank: int, cases: list, prompts: dict) -> list:
    """``ServeEngine(mesh=)`` on a (2, 2) CPU mesh for each case of
    ``cases``: ``(arch, batching)`` or ``(arch, batching, opts)``, the
    reduced config's seeded weights (``Model.init(0)``), four new tokens a
    request (``opts["news"]`` where given), float32, the prompts of
    ``prompts[opts.get("key", arch)]``; ``opts`` may also set ``max_len``,
    ``max_slots``, ``kv_budget_bytes`` and ``smem`` (the planner's shared
    memory).  Returns for each case its greedy tokens, the plan's
    ``kv_shard``, the KV budget, the page, the engine's stall count, each
    per-slot state buffer's global and local shapes (paged engines), how
    the Mamba2 scans and steps were called -- on DTensors (which the mixer
    hands to its local route) or on local tensors -- and the local query
    and KV heads of every paged-attention call.

    With ``opts["prefix"]`` the engine takes the radix prefix cache and
    serves the prompts one ``generate`` call each (the later ones hit the
    earlier ones' pages), and the case also returns the prefix metrics,
    the prefix bytes of ``stats()``, ``export_pages`` of the first prompt,
    each snapshot leaf's global and local element counts, and, of a fresh
    mesh engine that imported ``opts["import"]`` (an export from another
    engine), its own export of those pages and its tokens and hits
    serving the last prompt."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_model_config
    from repro_torch.hw import h100_spec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine, ServePolicy
    from repro_torch.serve.pages import init_paged_cache
    from repro_torch.tree import tree_flatten_with_paths

    calls = {}

    def counted(name, fn):
        def wrapped(*args, **kw):
            kind = "dtensor" if any(isinstance(a, DTensor)
                                    for a in args) else "local"
            calls[f"{name}/{kind}"] = calls.get(f"{name}/{kind}", 0) + 1
            return fn(*args, **kw)
        return wrapped

    def paged(fn):
        def wrapped(q, k_pages, *args, **kw):
            key = f"paged/{q.shape[1]}/{k_pages.shape[-2]}"
            calls[key] = calls.get(key, 0) + 1
            return fn(q, k_pages, *args, **kw)
        return wrapped

    M2.ssd_chunked = counted("scan", M2.ssd_chunked)
    M2.ssd_step = counted("step", M2.ssd_step)
    L.paged_attention = paged(L.paged_attention)
    mesh = make_host_mesh(model_axis=2, device="cpu")
    out = []
    for case in cases:
        arch, batching = case[:2]
        opts = case[2] if len(case) > 2 else {}
        cfg = get_model_config(arch).reduced()
        calls.clear()

        def engine(prefix="off"):
            return ServeEngine(
                cfg, ServePolicy(max_new_tokens=4,
                                 max_len=opts.get("max_len", 64),
                                 max_slots=opts.get("max_slots", 4),
                                 batching=batching, prefix_cache=prefix,
                                 kv_budget_bytes=opts.get(
                                     "kv_budget_bytes")),
                params=Model(cfg).init(0, "cpu", torch.float32),
                device="cpu", mesh=mesh,
                spec=h100_spec(smem_bytes=opts["smem"])
                if "smem" in opts else None)

        ps = prompts[opts.get("key", arch)]
        got = {}
        if opts.get("prefix"):
            eng = engine("radix")
            toks = [eng.generate([p])[0] for p in ps]
            st = eng.stats()
            got["prefix"] = {k: eng.metrics[k] for k in opts["prefix"]}
            got["prefix"].update({k: st[k] for k in (
                "prefix_state_bytes", "prefix_resident_bytes",
                "prefix_state_budget_bytes")})
            got["export"] = eng.export_pages(ps[0])
            # Each rank's snapshots hold the rows of its own heads only.
            snaps = [leaf for node in eng._paged_session.prefix._nodes
                     if node.state for leaf in tree_flatten_with_paths(
                         node.state).values()]
            got["snaps"] = [(leaf.numel(), leaf.to_local().numel())
                            for leaf in snaps]
            imp = engine("radix")
            payload = opts["import"]
            imp.import_pages(payload["tokens"], payload["pages"],
                             payload["snaps"])
            got["imported"] = {"export": imp.export_pages(
                payload["tokens"])}
            got["imported"].update(tokens=imp.generate([ps[-1]]),
                                   hits=imp.metrics["prefix_hits"])
        else:
            eng = engine()
            toks = eng.generate(ps, max_new_tokens=opts.get("news"))
        state = {}
        if batching == "paged":
            cache = eng._paged_steps(eng.policy.max_slots).place_cache(
                init_paged_cache(cfg, eng.policy.max_slots, 2,
                                 eng.page.page_tokens, 1, eng.dtype, "cpu",
                                 enc_len=4))
            state = {k: [list(v.shape), list(v.to_local().shape)]
                     for k, v in tree_flatten_with_paths(
                         cache["state"]).items()}
        got.update({"tokens": toks, "kv_shard": eng.plan.kv_shard(),
                    "budget": eng.budget_bytes,
                    "page_tokens": eng.page.page_tokens,
                    "stalls": eng.metrics["stalls"], "state": state,
                    "calls": dict(calls)})
        out.append(got)
    return out


def serve_one_rank_world(rank: int, cases: list) -> list:
    """``ServeEngine(mesh=)`` on a one-rank (1, 1) CPU mesh for each
    ``(arch, batching, prefix_cache)`` of ``cases``: the greedy tokens of
    one short prompt (the reduced config's seeded weights, float32)."""
    from repro_torch.configs import get_model_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine, ServePolicy

    mesh = make_host_mesh(model_axis=1, device="cpu")
    out = []
    for arch, batching, prefix in cases:
        cfg = get_model_config(arch).reduced()
        eng = ServeEngine(cfg, ServePolicy(max_new_tokens=3, max_len=64,
                                           max_slots=2, batching=batching,
                                           prefix_cache=prefix),
                          params=Model(cfg).init(0, "cpu", torch.float32),
                          device="cpu", mesh=mesh)
        out.append(eng.generate([np.arange(5, dtype=np.int32)]))
    return out


def forward_world(rank: int, arch: str, tokens: np.ndarray) -> np.ndarray:
    """The reduced ``arch``'s training forward (remat none, float32) on a
    (2, 2) CPU mesh under its ``arch_rules``, the batch guarded
    (``with_batch_guard``): a batch the data axis does not divide runs
    replicated over it.  Returns the logits gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_model_config
    from repro_torch.dist.sharding import (arch_rules, param_shardings,
                                           placements, use_mesh_rules,
                                           with_batch_guard)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.trainer import distribute
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    cfg = get_model_config(arch).reduced()
    model = Model(cfg, remat="none")
    mesh = make_host_mesh(model_axis=2, device="cpu")
    rules = with_batch_guard(arch_rules(cfg, mesh), mesh, tokens.shape[0])
    shard = param_shardings(mesh, rules, model.param_specs())
    params = tree_map(lambda p, pl: distribute(p, mesh, pl),
                      model.init(0, "cpu", torch.float32), shard)
    tok = torch.from_numpy(tokens.astype(np.int64))
    tok = distribute(tok, mesh, placements(mesh, rules.act_spec(
        ("batch", "seq"))))
    with torch.no_grad(), use_mesh_rules(mesh, rules), \
            implicit_replication():
        logits, _ = model.forward(params, {"tokens": tok, "labels": tok},
                                  torch.float32)
    return _np(logits)


# ---------------------------------------------------------------------------
# The row-parallel product, the vocab-parallel loss, meshed steps
# ---------------------------------------------------------------------------


def row_parallel_world(rank: int, inputs: str) -> dict:
    """``layers.tp_matmul(x, w, "row")`` under gspmd rules on a (2, 2)
    mesh, ``x``'s contraction dim and ``w``'s rows sharded over "model",
    with the batch sharded over "data" and replicated over it: the output
    and the gradients of ``<y, seed>`` (gathered), the placements of ``y``,
    and the ``mm`` FLOPs this rank's backward traces
    (``roofline.ops.analyze_ops``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sharding import ShardingRules, use_mesh_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import tp_matmul
    from repro_torch.roofline.ops import analyze_ops

    torch.set_num_threads(1)
    d = _load(inputs)
    mesh = make_host_mesh(model_axis=2, device="cpu")
    rules = ShardingRules({}, {})
    out = {}
    for name, batch in (("sharded", Shard(0)), ("replicated", Replicate())):
        x = torch.from_numpy(d["x"]).requires_grad_(True)
        w = torch.from_numpy(d["w"]).requires_grad_(True)
        xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                                run_check=False).redistribute(
            mesh, [batch, Shard(2)])
        wd = DTensor.from_local(w, mesh, [Replicate(), Replicate()],
                                run_check=False).redistribute(
            mesh, [Replicate(), Shard(0)])
        with use_mesh_rules(mesh, rules):
            y = tp_matmul(xd, wd, "row")
        out[f"{name}/placements"] = np.array([str(p) for p in y.placements])
        total = (y.full_tensor() * torch.from_numpy(d["seed"])).sum()
        ops = analyze_ops(total.backward)
        out[f"{name}/y"] = _np(y)
        out[f"{name}/dx"] = _np(x.grad)
        out[f"{name}/dw"] = _np(w.grad)
        out[f"{name}/mm_flops"] = np.array(
            sum(v for k, v in ops.flops_by_op.items()
                if k in ("mm", "bmm", "addmm")))
    return out


def loss_world(rank: int, inputs: str) -> dict:
    """``layers.cross_entropy_loss`` on (2, 2): float32 logits ``(B, S,
    V)`` with the batch over "data" and the vocab over "model", with and
    without z-loss: the loss, the logits' gradient (gathered), and the
    shapes of every all-gather the backward and forward ask for."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.dist.sharding import ShardingRules, use_mesh_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.roofline.ops import analyze_ops

    torch.set_num_threads(1)
    d = _load(inputs)
    mesh = make_host_mesh(model_axis=2, device="cpu")
    rules = ShardingRules({}, {"batch": "data", "vocab": "model"})
    out = {}
    for z in (0.0, 1e-4):
        ld = distribute_tensor(torch.from_numpy(d["logits"]), mesh,
                               [Shard(0), Shard(2)]).requires_grad_(True)
        lb = DTensor.from_local(torch.from_numpy(d["labels"]), mesh,
                                [Replicate(), Replicate()],
                                run_check=False).redistribute(
            mesh, [Shard(0), Replicate()])
        box = {}

        def run():
            with use_mesh_rules(mesh, rules):
                box["loss"] = cross_entropy_loss(ld, lb, z_loss=z)
            box["loss"].full_tensor().backward()

        ops = analyze_ops(run)
        out[f"{z}/loss"] = _np(box["loss"])
        out[f"{z}/grad"] = _np(ld.grad)
        out[f"{z}/gathers"] = np.array(
            [list(s[0]) for k, s in ops.collectives if k == "all-gather"]
            or np.zeros((0, 3), dtype=np.int64))
    return out


def step_world(rank: int, inputs: str, archs: list, seq_len: int,
               batch: int) -> dict:
    """One float32 training step (remat none, gspmd rules) of each reduced
    arch of ``archs`` on a (2, 2) mesh, from its parameters and batch in
    ``inputs``: the new state and metrics, gathered (``_step``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.trainer import make_train_step

    torch.set_num_threads(1)
    d = _load(inputs)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    shape = ShapeConfig("tiny", seq_len=seq_len, global_batch=batch,
                        kind="train")
    train = TrainConfig(dtype="float32", remat="none", warmup_steps=2,
                        total_steps=10)
    out = {}
    for arch in archs:
        cfg = _cfg(arch)
        ts = make_train_step(cfg, shape, mesh, train)
        for k, v in _step(d, arch, ts, cfg).items():
            out[f"{arch}/step/{k}"] = v
    return out


#: The mLSTM block cases of ``mlstm_world``: reduced xlstm-1.3b at 4 heads
#: (its heads fill the (1, 4) mesh's model axis: "state_heads") and at 2
#: ("state_inner": the state's key dim splits).
MLSTM_CASES = {"heads": "xlstm-1.3b", "inner": "xlstm-1.3b-2h"}
#: The chunk the block's chunkwise cell runs at (two chunks a call).
MLSTM_CHUNK = 8


def mlstm_world(rank: int, inputs: str) -> dict:
    """One mLSTM block (``models.xlstm.mlstm_block``) of each
    ``MLSTM_CASES`` config on a (1, 4) mesh under ``arch_rules``, from its
    parameters, inputs and cache in ``inputs``: the output and the
    gradients of ``<out, seed>`` (gathered) with the FLOPs this rank's
    forward and backward trace (``roofline.ops.analyze_ops``), all and
    the cell's (its ``bmm``: the projections are ``mm``); then, from
    the cache placed as ``launch.specs.cache_logical_axes`` places it, a
    chunkwise call and a decode step (outputs and new state, gathered),
    the new ``C``'s placements, and the shapes of every all-gather the
    two calls ask for."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import (arch_rules, logical_sharding,
                                           param_shardings, use_mesh_rules)
    from repro_torch.launch.specs import cache_logical_axes
    from repro_torch.launch.trainer import distribute
    from repro_torch.models.xlstm import mlstm_block, mlstm_param_specs
    from repro_torch.roofline.ops import analyze_ops

    torch.set_num_threads(1)
    d = _load(inputs)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    out = {}
    for case, arch in MLSTM_CASES.items():
        cfg = _cfg(arch)
        rules = arch_rules(cfg, mesh)
        pre = f"mlstm/{case}/"
        pl = param_shardings(mesh, rules, mlstm_param_specs(cfg))
        params = {k: distribute(torch.from_numpy(d[pre + "p/" + k]), mesh,
                                pl[k]).requires_grad_(True) for k in pl}
        x = torch.from_numpy(d[pre + "x"]).requires_grad_(True)
        xd = distribute(x, mesh, logical_sharding(
            mesh, rules, ("batch", None, None), x.shape, "act"))
        box = {}

        def run():
            with use_mesh_rules(mesh, rules):
                box["y"], _ = mlstm_block(params, xd, cfg, None, MLSTM_CHUNK)
            (box["y"].full_tensor() * torch.from_numpy(d[pre + "seed"])
             ).sum().backward()

        ops = analyze_ops(run)
        out[pre + "flops"] = np.array(ops.flops)
        out[pre + "cell_flops"] = np.array(ops.flops_by_op.get("bmm", 0.0))
        out[pre + "y"] = _np(box["y"])
        out[pre + "dx"] = _np(x.grad)
        for k, v in params.items():
            out[pre + "d/" + k] = _np(v.grad)
        stack = {k: torch.from_numpy(d[pre + "c/" + k])[None]
                 for k in ("conv", "C", "n", "m")}
        axes = cache_logical_axes(cfg, stack, False)
        cache = {k: distribute(v, mesh, logical_sharding(
            mesh, rules, axes[k], v.shape, "act"))[0]
            for k, v in stack.items()}
        xs = [distribute(torch.from_numpy(d[pre + k]), mesh,
                         xd.placements) for k in ("x_chunk", "x_step")]
        box = {}

        def serve():
            with torch.no_grad(), use_mesh_rules(mesh, rules):
                box["chunk"] = mlstm_block(params, xs[0], cfg, cache,
                                           MLSTM_CHUNK)
                box["step"] = mlstm_block(params, xs[1], cfg,
                                          box["chunk"][1], MLSTM_CHUNK)

        ops = analyze_ops(serve)
        for call in ("chunk", "step"):
            y, new = box[call]
            out[f"{pre}{call}/y"] = _np(y)
            for k, v in new.items():
                out[f"{pre}{call}/c/{k}"] = _np(v)
        out[pre + "C_placements"] = np.array(
            [str(p) for p in box["step"][1]["C"].placements])
        out[pre + "serve_gathers"] = [
            tuple(s) for k, shapes in ops.collectives if k == "all-gather"
            for s in shapes]
    return out


def embed_world(rank: int, inputs: str) -> dict:
    """``layers.embed_tokens`` on (2, 2): the table's vocab over "model"
    with its columns replicated and, as FSDP places it, sharded over
    "data"; the ids' rows over "data".  The rows and the table's gradient
    of ``<rows, seed>`` (gathered), and the shapes of every all-gather the
    forward and backward ask for."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.trainer import distribute
    from repro_torch.models.layers import embed_tokens
    from repro_torch.roofline.ops import analyze_ops

    torch.set_num_threads(1)
    d = _load(inputs)
    mesh = make_host_mesh(model_axis=2, device="cpu")
    ids = distribute(torch.from_numpy(d["embed/ids"]), mesh,
                     (Shard(0), Replicate()))
    out = {}
    for name, place in (("replicated", (Replicate(), Shard(0))),
                        ("fsdp", (Shard(1), Shard(0)))):
        table = distribute(torch.from_numpy(d["embed/table"]), mesh,
                           place).requires_grad_(True)
        box = {}

        def run():
            box["rows"] = embed_tokens({"embedding": table}, ids,
                                       torch.float32)
            (box["rows"].full_tensor() * torch.from_numpy(d["embed/seed"])
             ).sum().backward()

        ops = analyze_ops(run)
        out[f"embed/{name}/rows"] = _np(box["rows"])
        out[f"embed/{name}/grad"] = _np(table.grad)
        out[f"embed/{name}/grad_placements"] = np.array(
            [str(p) for p in table.grad.placements])
        out[f"embed/{name}/gathers"] = [
            tuple(s) for k, shapes in ops.collectives if k == "all-gather"
            for s in shapes]
    return out


def repairs_world(rank: int, inputs: str, steps: list) -> dict:
    """``row_parallel_world``, ``loss_world``, ``embed_world``,
    ``mlstm_world`` and ``step_world`` in one world: ``steps`` holds
    ``(npz, archs, seq_len, batch)`` groups, a ``step_world`` call each."""
    out = row_parallel_world(rank, inputs)
    out.update(loss_world(rank, inputs))
    out.update(embed_world(rank, inputs))
    out.update(mlstm_world(rank, inputs))
    for group in steps:
        out.update(step_world(rank, *group))
    return out
