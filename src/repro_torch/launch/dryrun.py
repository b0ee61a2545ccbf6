"""Multi-pod dry run (the port of ``repro.launch.dryrun``): trace every
(architecture x input shape) cell's step on the production meshes with no
card, proving the distribution config is coherent, and report each cell's
per-card FLOPs, HBM bytes, collective bytes, roofline terms and peak
memory.

The reference lowers and compiles each cell on XLA's forced host devices.
The port's counterpart runs each cell's step ONCE under ``FakeTensorMode``
(tensors with shapes and no storage) on ``launch.mesh
.make_production_mesh``'s fake world of 256 or 512 ranks, as rank 0:

  * the state is created shard by shard on the mesh (``init_train_state``
    draws each leaf and keeps rank 0's shard; the serving parameters the
    same through ``Model.init(place=)``), so the memory read is one
    rank's;
  * ``roofline.ops.analyze_ops`` counts the step's ops on their local
    shards (the counterpart of the reference's HLO analysis) and
    ``roofline.report.roofline_terms`` turns the counts into the H100's
    bounds;
  * torch's ``MemTracker`` reads the rank's peak bytes (the counterpart of
    XLA's memory analysis);
  * a step whose loops run more than ``MAX_BLOCK_TRIPS`` trips (every
    prefill_32k cell's blockwise attention, the xLSTM's tokens and chunks)
    runs each loop's first, second and last trips, the second counted for
    every middle one (``roofline.ops.loop``), as the reference traces a
    ``lax.scan`` body once; the peak is then the traced trips' on top of
    the state that persists across them.  The report's ``counted`` says
    which way a cell was counted.

The report keeps the reference's keys, less the compile (and adds
``collective_result_bytes``: what each collective hands back to the rank,
an all-gather's gathered tensor, beside the reference's operand bytes in
``collective_bytes``): ``lower_s`` and
``compile_s`` become ``trace_s`` (host seconds of the traced step: a
host-CPU time, never a card's), ``xla_cost_flops_looponce`` goes,
``memory.peak_bytes`` is ``MemTracker``'s per-rank peak and
``memory.argument_bytes`` the local parameters, moments (train) or cache
(serve) and batch.  Reports go to ``--out``, by default a directory under
``$TMPDIR`` (the reference writes ``experiments/dryrun/``).

``--calibrate`` compares ``phi_mesh``'s per-card estimate with the traced
peak, cell by cell, and folds the worst ratio per arch into the port's
calibration artifact (``configs.base.calibration_path()``, or
``--calibration-out``), the ``overhead`` and ``act_scale`` every later
plan reads.  ``--plan-tree`` prints each arch's hierarchical plan on the
meshes, tracing nothing.

One process holds one world, so ``--mesh both`` runs the single-pod cells,
destroys that world, then runs the multi-pod ones.

  python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k,decode_32k --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import torch

from repro_torch.configs import (
    TrainConfig,
    get_model_config,
    get_shape,
    list_archs,
)
from repro_torch.launch.mesh import make_production_mesh

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

#: Loop trips of the eager step (all layers) past which a cell is not
#: traced whole: blockwise attention runs every (query block, key block)
#: pair as its own ops, the sLSTM one token at a time and the mLSTM one
#: chunk at a time, and the host traces some 20 ops a trip.  Past it each
#: such loop runs one trip, counted for all of them
#: (``roofline.ops.sampling_loops``), as the reference counts a
#: ``lax.scan`` traced once.
MAX_BLOCK_TRIPS = 20_000


def results_dir() -> str:
    """The default report directory: under ``$TMPDIR``, never a path a test
    or a plan reads."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_dryrun")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def skip_reason(arch: str, shape_name: str) -> str:
    """Cells skipped per the assignment, with the one-line reason."""
    cfg = get_model_config(arch)
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "attention (see DESIGN.md §4)")
    return ""


def block_trips(cfg, shape) -> int:
    """The eager loop trips of one step's prompt: blockwise attention's
    block pairs (0 where attention takes the whole sequence at once), or
    for xLSTM the sLSTM's tokens and the mLSTM's chunks."""
    from repro_torch.core.autotile import plan_attention
    from repro_torch.serve.kvcache import attn_apps

    s = shape.seq_len
    if shape.kind == "decode":
        return 0
    if cfg.family == "xlstm":
        n_s = cfg.n_layers // cfg.xlstm.slstm_every
        chunk = min(256, max(16, s))
        return n_s * s + (cfg.n_layers - n_s) * -(-s // chunk)
    if s <= cfg.attn_blockwise_threshold:
        return 0
    layers = attn_apps(cfg) if cfg.family == "hybrid_ssm" else cfg.n_layers
    if cfg.family == "enc_dec":
        layers = cfg.enc_dec.n_encoder_layers + cfg.enc_dec.n_decoder_layers
    plan = plan_attention(s, s, cfg.head_dim, dtype_bytes=2)
    return (-(-s // int(plan.block_q))) * (-(-s // int(plan.block_kv))) \
        * max(1, layers)


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _zeros_batch(specs) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}


def _host_counters(cache, filled: int):
    """The cache's host counters (``len``) as host integers at ``filled``
    tokens: under ``FakeTensorMode`` a tensor holds no value to read back
    (the traced step reads each layer's length once)."""
    import numpy as np

    if not isinstance(cache, dict):
        return cache
    return {k: (np.full(tuple(v.shape), filled, np.int64) if k == "len"
                else _host_counters(v, filled)) for k, v in cache.items()}


def _peak_bytes(mt) -> int:
    snap = mt.get_tracker_snapshot("peak")
    return int(max((v.get("Total", 0) for d, v in snap.items()
                    if torch.device(d).type != "meta"), default=0))


def _local_mem_tracker():
    """torch's ``MemTracker``, seeing local tensors only: an op on
    DTensors is handed back to DTensor (whose local ops it then sees), and
    DTensor's sharding propagation (fake global tensors no rank holds) is
    not tracked, so the peak is one rank's."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    from repro_torch.roofline.ops import propagating

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _trace(fn, args, externals, sample: bool = False):
    """``fn(*args)`` once under the op counter and the memory tracker:
    ``(OpSummary, peak bytes, output bytes, seconds)``.  ``sample`` runs
    the step's long loops one trip each, counted for all of them; the
    peak is then the traced trip's on top of what persists across
    trips."""
    from repro_torch.roofline.ops import analyze_ops_with_result, \
        sampling_loops
    from repro_torch.tree import tree_leaves

    mt = _local_mem_tracker()
    ext = [t for t in tree_leaves(externals) if isinstance(t, torch.Tensor)]
    mt.track_external(*ext)
    t0 = time.time()
    with sampling_loops(sample):
        summary, out = analyze_ops_with_result(_under(mt, fn), *args)
    return summary, _peak_bytes(mt), _local_bytes(out), time.time() - t0


def _under(ctx, fn):
    def run(*args):
        with ctx:
            return fn(*args)
    return run


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cache_policy: str = "baseline", *,
               mesh=None, cfg=None, shape=None) -> dict:
    """Trace one cell's step on the production mesh (see the module
    docstring).  Returns the report dict (the port keeps no per-cell
    artifact beside it, so the reference's ``out_root`` has no
    counterpart).  ``mesh``, ``cfg`` and ``shape`` replace the production mesh
    (any ``DeviceMesh`` over a running world, fake or not), the registered
    config and the named shape (a reduced cell).  A step of more than
    ``MAX_BLOCK_TRIPS`` loop trips samples its loops (the report's
    ``counted`` says so)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.specs import decode_batch_specs, \
        train_batch_specs
    from repro_torch.launch.trainer import distribute, init_train_state, \
        make_train_step
    from repro_torch.roofline import roofline_terms
    from repro_torch.serve.steps import make_serve_steps

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = _mesh_name(multi_pod)
    else:
        mesh_name = "x".join(str(n) for n in mesh.shape)
    cfg = cfg or get_model_config(arch)
    shape = shape or get_shape(shape_name)
    trips = block_trips(cfg, shape)
    sample = trips > MAX_BLOCK_TRIPS
    t_build = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            train = TrainConfig(remat="full", microbatches=1)
            ts = make_train_step(cfg, shape, mesh, train)
            params, opt = init_train_state(ts, 0, train)
            batch = ts.place_batch(_zeros_batch(train_batch_specs(cfg,
                                                                  shape)))
            fn, args = ts.fn, (params, opt, batch)
            externals = (params, opt, batch)
            step_kind = "train_step"
        else:
            ss = make_serve_steps(cfg, shape, mesh,
                                  cache_policy=cache_policy)

            def place(path, leaf):
                pl = ss.param_sharding
                for k in path.split("."):
                    pl = pl[k]
                return distribute(leaf, mesh, pl)

            params = ss.model.init(0, "cpu", torch.float32, place=place)
            if shape.kind == "prefill":
                batch = _zeros_batch(train_batch_specs(cfg, shape))
                batch.pop("labels", None)
                def fn(params, batch):
                    return ss.prefill(params, batch, then=lambda c:
                                      _host_counters(c, 0))
                args = (params, batch)
                externals = (params, batch)
                step_kind = "prefill_step"
            else:
                cache = _host_counters(ss.place_cache(ss.model.init_cache(
                    shape.global_batch, shape.seq_len, torch.bfloat16,
                    enc_len=shape.seq_len, device="cpu")), shape.seq_len - 1)
                batch = _zeros_batch(decode_batch_specs(cfg, shape))
                fn, args = ss.decode, (params, cache, batch)
                externals = (params, cache, batch)
                step_kind = "serve_step"
        build_s = time.time() - t_build
        arg_bytes = _local_bytes(externals)
        summary, peak, out_bytes, trace_s = _trace(fn, args, externals,
                                                   sample)
    terms = roofline_terms(cfg, shape, mesh_name, step_kind, summary,
                           n_chips=mesh.size())
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "step": step_kind,
        "status": "ok",
        "build_s": round(build_s, 1),
        "trace_s": round(trace_s, 1),
        "counted": {"loops": "sampled loops" if sample else "whole step",
                    "trips": trips},
        "flops": summary.flops,
        "hbm_bytes": summary.hbm_bytes,
        "collective_bytes": dict(summary.collective_bytes),
        "collective_result_bytes": dict(summary.collective_result_bytes),
        "collective_shapes": sorted({(kind, tuple(shape))
                                     for kind, shapes in summary.collectives
                                     for shape in shapes}),
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "bottleneck": terms.bottleneck,
            "model_flops_per_chip": terms.model_flops_per_chip,
            "useful_ratio": terms.useful_ratio,
            "mfu_bound": terms.mfu_bound,
            "ideal_bound_s": terms.ideal_bound_s,
            "roofline_fraction": terms.roofline_fraction,
            "row": terms.row(),
        },
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(0, peak - arg_bytes),
            "peak_bytes": peak,
        },
    }


def print_plan_tree(arch: str, multi_pod: bool, mesh=None) -> list:
    """Print (and return) the full hierarchical plan for one arch on a
    production mesh -- the planner walk the trainer consumes, tracing
    nothing.  ``mesh`` may be any object with the mesh's axis names and
    sizes (an ``AbstractMesh``); by default the production mesh's.  The
    multi-pod mesh carries a "pod" axis, so its tree has a DCN level above
    the NVLINK one."""
    from repro_torch.dist.sharding import AbstractMesh, \
        TRAIN_STATE_BYTES_PER_PARAM, mesh_plan
    from repro_torch.launch.mesh import PRODUCTION_MESHES
    from repro_torch.launch.specs import activation_footprint

    if mesh is None:
        shape_, axes = PRODUCTION_MESHES[bool(multi_pod)]
        mesh = AbstractMesh(shape_, axes)
    cfg = get_model_config(arch)
    shape = get_shape("train_4k")
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    model_n = sizes.get("model", 1)
    total = 1
    for v in sizes.values():
        total *= v
    data_n = max(1, total // model_n)
    hp = mesh_plan(
        mesh,
        state_bytes=cfg.param_count() * TRAIN_STATE_BYTES_PER_PARAM // model_n,
        act_bytes=activation_footprint(cfg, shape, "full") // data_n,
        max_np=data_n,
        overhead=cfg.overhead,
        matmul=(shape.seq_len, cfg.d_model, cfg.d_ff or cfg.d_model),
    )
    lines = [f"[plan] {arch} on {_mesh_name(multi_pod)}:"]
    lines += ["  " + line for line in hp.describe()]
    for line in lines:
        print(line)
    return lines


def calibrate_cell(arch: str, shape_name: str, multi_pod: bool = False
                   ) -> dict:
    """Compare ``phi_mesh``'s per-card estimate with the traced per-rank
    peak (the reference compares it with XLA's memory analysis).

    The estimate is evaluated at the FSDP degree the rules realise (the
    full data axes when sharded, 1 when replicated).  A ratio < 1 means
    ``phi_mesh`` underestimates the resident transients -- raise
    ``overhead`` toward ``1/ratio``.  Train cells also fit the replicated
    (activation) term: the peak less the sharded-state estimate is the
    activation-implied residual, and modeled / implied calibrates
    ``act_scale``."""
    from repro_torch.configs.base import calibration_act_scale
    from repro_torch.core.decompose import make_phi_mesh
    from repro_torch.core.distribution import (
        Array1DDistribution,
        ReplicatedDistribution,
    )
    from repro_torch.dist.sharding import arch_rules
    from repro_torch.launch.specs import activation_footprint, \
        decode_footprint

    rep = lower_cell(arch, shape_name, multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_model_config(arch)
    shape = get_shape(shape_name)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    data_n = max(1, mesh.size() // sizes.get("model", 1))
    if shape.kind == "train":
        rules = arch_rules(
            cfg, mesh,
            act_bytes=activation_footprint(cfg, shape, "full") // data_n)
    else:
        rules = arch_rules(
            cfg, mesh, state_bytes_per_param=2,
            act_bytes=decode_footprint(cfg, shape,
                                       shape.seq_len) // mesh.size())
    lp = rules.meta["plan"].level("NVLINK")
    realized = rules.meta["fsdp_capacity"] if rules.meta["fsdp"] else 1
    phi = make_phi_mesh(overhead=lp.detail["overhead"])
    dists = [Array1DDistribution(
        length=max(1, lp.detail["sharded_bytes"]), element_size=1)]
    if lp.detail["replicated_bytes"]:
        dists.append(ReplicatedDistribution(lp.detail["replicated_bytes"]))
    terms = [phi(lp.granule_bytes, d, realized) for d in dists]
    est = sum(terms)
    peak = rep["memory"]["peak_bytes"]
    ratio = est / peak if peak else float("inf")
    mesh_name = _mesh_name(multi_pod)
    print(f"[cal] {arch} x {shape_name} ({mesh_name}): "
          f"phi_mesh_est={est / 2 ** 30:.2f}GiB "
          f"traced_peak={peak / 2 ** 30:.2f}GiB "
          f"calibration_ratio={ratio:.2f} (overhead={cfg.overhead})")
    print(f"[cal]   roofline {rep['roofline']['row']} "
          f"trace_s={rep['trace_s']}")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "phi_mesh_est_bytes": est, "traced_peak_bytes": peak,
           "calibration_ratio": ratio, "overhead": cfg.overhead,
           "roofline_row": rep["roofline"]["row"]}
    if shape.kind == "train" and len(terms) > 1 and peak:
        act_est = terms[1]
        act_residual = max(1.0, peak - terms[0])
        rec.update({
            "act_est_bytes": act_est,
            "act_residual_bytes": act_residual,
            "act_ratio": act_est / act_residual,
            "act_scale": calibration_act_scale(arch) or 1.0,
        })
        print(f"[cal]   act: modeled={act_est / 2 ** 30:.2f}GiB "
              f"implied={act_residual / 2 ** 30:.2f}GiB "
              f"act_ratio={rec['act_ratio']:.2f} "
              f"(act_scale={rec['act_scale']})")
    return rec


def write_calibration(records: list, path: str = None) -> str:
    """Fold per-cell calibration records into the port's calibration
    artifact (``configs.base.calibration_path()`` unless ``path``).

    ``est = overhead * phi_mesh_terms``, so the overhead that makes the
    estimate meet the worst observed cell is ``overhead / min(ratio)``,
    clamped at 1.0; ``act_scale`` likewise from the worst train cell (a
    run without one carries the arch's earlier act fields forward).
    Entries of other archs are kept."""
    from repro_torch.configs.base import calibration_path

    path = path or calibration_path()
    existing = {}
    try:
        with open(path) as f:
            existing = json.load(f)
    except (OSError, ValueError):
        pass
    by_arch: dict = {}
    for rec in records:
        by_arch.setdefault(rec["arch"], []).append(rec)
    for arch, recs in by_arch.items():
        finite = [r for r in recs
                  if r["calibration_ratio"] not in (0, float("inf"))]
        if not finite:
            continue
        worst = min(finite, key=lambda r: r["calibration_ratio"])
        entry = {
            "overhead": round(max(1.0, worst["overhead"]
                                  / worst["calibration_ratio"]), 3),
            "worst_ratio": round(worst["calibration_ratio"], 4),
            "worst_cell": f"{worst['shape']}@{worst['mesh']}",
            "cells": len(recs),
        }
        acts = [r for r in recs
                if r.get("act_ratio") not in (None, 0, float("inf"))]
        if acts:
            worst_a = min(acts, key=lambda r: r["act_ratio"])
            entry["act_scale"] = round(
                max(1.0, worst_a["act_scale"] / worst_a["act_ratio"]), 3)
            entry["act_worst_ratio"] = round(worst_a["act_ratio"], 4)
            entry["act_worst_cell"] = \
                f"{worst_a['shape']}@{worst_a['mesh']}"
        else:
            prev = existing.get(arch, {})
            for k in ("act_scale", "act_worst_ratio", "act_worst_cell"):
                if isinstance(prev, dict) and k in prev:
                    entry[k] = prev[k]
        existing[arch] = entry
    existing["_meta"] = {
        "source": "python -m repro_torch.launch.dryrun --calibrate",
        "note": "overhead = registered_overhead / min(phi_mesh_est / "
                "traced_peak); act_scale = used_act_scale / min(act_est / "
                "act_implied_residual); traced peaks are torch MemTracker's "
                "per-rank peaks of the step under FakeTensorMode on the "
                "production mesh (host tracing, no card)",
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    print(f"[cal] wrote {path} ({len(by_arch)} arch(es))")
    return path


def _release_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="one shape, a comma-separated list, or 'all' (a "
                         "--calibrate run must cover an arch's shapes in "
                         "ONE invocation: write_calibration folds the "
                         "worst cell a run)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None,
                    help=f"report directory (default {results_dir()})")
    ap.add_argument("--cache_policy", default="baseline",
                    choices=["baseline", "auto"])
    ap.add_argument("--plan-tree", action="store_true",
                    help="print each arch's hierarchical plan on the "
                         "meshes and exit -- no tracing")
    ap.add_argument("--calibrate", action="store_true",
                    help="trace each cell, print the phi_mesh vs traced-"
                         "peak calibration ratio, and fold the results into "
                         "the port's calibration artifact")
    ap.add_argument("--calibration-out", default=None,
                    help="override the calibration artifact path "
                         "(default: configs.base.calibration_path())")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else \
        [a.strip() for a in args.arch.split(",") if a.strip()]
    shapes = (list(SHAPE_NAMES) if args.shape == "all"
              else [s.strip() for s in args.shape.split(",") if s.strip()])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.plan_tree:
        for arch in archs:
            for multi_pod in meshes:
                print_plan_tree(arch, multi_pod)
        return 0

    if args.calibrate:
        n_fail = 0
        records = []
        for multi_pod in meshes:
            for arch in archs:
                for shape_name in shapes:
                    if skip_reason(arch, shape_name):
                        continue
                    try:
                        records.append(calibrate_cell(
                            arch, shape_name, multi_pod))
                    except Exception as e:
                        n_fail += 1
                        print(f"[cal-FAIL] {arch} x {shape_name}: {e}")
            _release_world()
        if records:
            write_calibration(records, path=args.calibration_out)
        return 1 if n_fail else 0

    out_dir = args.out or results_dir()
    os.makedirs(out_dir, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for multi_pod in meshes:
        for arch in archs:
            for shape_name in shapes:
                reason = skip_reason(arch, shape_name)
                tag = f"{arch}__{shape_name}__{_mesh_name(multi_pod)}"
                path = os.path.join(out_dir, tag + ".json")
                base = {"arch": arch, "shape": shape_name,
                        "mesh": _mesh_name(multi_pod)}
                if reason:
                    rep = dict(base, status="skipped", reason=reason)
                    n_skip += 1
                    print(f"[skip] {tag}: {reason}")
                else:
                    try:
                        rep = lower_cell(arch, shape_name, multi_pod,
                                         cache_policy=args.cache_policy)
                        n_ok += 1
                        print(f"[ok]   {tag}  trace={rep['trace_s']}s "
                              f"counted={rep['counted']['loops']} "
                              f"flops={rep['flops']:.4g} "
                              f"peak={rep['memory']['peak_bytes']}")
                    except Exception as e:      # report, keep going
                        rep = dict(base, status="failed", error=repr(e),
                                   traceback=traceback.format_exc()[-2000:])
                        n_fail += 1
                        print(f"[FAIL] {tag}: {e!r}"[:400])
                with open(path, "w") as f:
                    json.dump(rep, f, indent=1)
                sys.stdout.flush()
        _release_world()
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
