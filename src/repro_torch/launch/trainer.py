"""The training step factory and the training loop (the port of
``repro.launch.trainer``).

``make_train_step`` builds the step: the float32 parameters cast to the
compute dtype inside the loss, ``Model.loss`` differentiated by
``torch.autograd``, gradient accumulation over equal microbatches of the
batch (gradients summed in float32 and divided by their count), the
gradient compression's round trip when one is set, then AdamW.

On a mesh (a ``DeviceMesh`` with axes ``("data", "model")``, from
``launch.mesh.make_host_mesh``) it does what the reference's sharded step
does: ``arch_rules`` with the activation reserve divided by the data
extent, ``with_batch_guard``, ``resolve_collectives`` ("gspmd", "ring",
"serpentine" or "auto"); parameters, moments and batch are DTensors with
the rules' placements.  The loss runs under ``use_mesh_rules`` (the
``constrain`` sites, the ring dispatch) and DTensor's
``implicit_replication`` (the model's plain index tensors -- positions,
masks -- count as replicated), and each gradient is redistributed to its
parameter's placements (the data-parallel reduction) before AdamW.
Without a mesh the step runs on one ``device``, with plain tensors; there
are no collectives to schedule, so ``collectives`` is only checked.

The parameters are leaf tensors that require grad.  The update runs under
``torch.no_grad()`` and rebinds: ``adamw_update`` returns new parameter
and moment tensors, and the step hands back the new parameters as leaves
that require grad.

``Trainer`` wires the fault-tolerance substrate as the reference does:
async keep-k checkpoints (the reference's format, written by rank 0 from
the gathered leaves), the preemption drain, the step watchdog and the
straggler policy, and restore by name onto whatever mesh (or device) the
relaunch built -- elastic restore.  On several ranks the ranks agree on
the preemption flag and on the checkpoint to restore before acting.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.dist.sharding import (
    COLLECTIVES,
    ShardingRules,
    arch_rules,
    param_shardings,
    placements,
    resolve_collectives,
    use_mesh_rules,
    with_batch_guard,
)
from repro_torch.launch.specs import activation_footprint, batch_logical_axes
from repro_torch.models.model import Model
from repro_torch.optim import (
    OptState,
    adamw_init,
    adamw_update,
    compress_gradient,
    decompress_gradient,
)
from repro_torch.tree import (
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

PyTree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def distribute(t: torch.Tensor, mesh, place) -> DTensor:
    """``t`` (the same full value on every rank) as a DTensor with
    ``place``: each rank keeps a copy of its own shard, with no
    communication, so ``t`` can be let go."""
    d = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
    return d if tuple(place) == tuple(d.placements) else \
        d.redistribute(mesh, place)


def _world() -> int:
    """The size of the running process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _full(t):
    """A metric as a plain tensor (a DTensor gathered whole)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


@dataclass
class TrainStep:
    fn: Callable              # (params, opt, batch) -> (params, opt, metrics)
    model: Model
    device: torch.device
    mesh: Any = None          # the DeviceMesh, None on one device
    rules: Optional[ShardingRules] = None
    param_sharding: PyTree = None     # placements tree (mesh only)
    batch_sharding: Optional[Dict[str, tuple]] = None

    def place_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A host or device batch (the same on every rank) on this step's
        device, as DTensors with the batch placements on a mesh."""
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        if self.mesh is None:
            return out
        return {k: distribute(v, self.mesh, self.batch_sharding[k])
                for k, v in out.items()}


def make_train_step(cfg, shape, mesh=None, train: TrainConfig = TrainConfig(),
                    rules: Optional[ShardingRules] = None,
                    device=None) -> TrainStep:
    """The train step for ``cfg`` over ``mesh`` (sharded) or, without one,
    on ``device`` (default the card).  ``shape`` is the batch the step
    takes; its global batch must split into ``train.microbatches`` equal
    microbatches.  On a mesh, ``rules`` replaces the planner's (built, for
    example, against a shrunk HBM that forces FSDP)."""
    if train.collectives not in COLLECTIVES + ("auto",):
        raise ValueError(f"unknown collectives {train.collectives!r}; one "
                         f"of {COLLECTIVES + ('auto',)}")
    mb = max(1, train.microbatches)
    if shape.global_batch % mb:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {mb} microbatches")
    model = Model(cfg, remat=train.remat)
    compute_dtype = _dtype(train.dtype)
    p_shard = b_shard = None
    if mesh is None:
        device = resolve_device(device)
        scope = contextlib.nullcontext
    else:
        device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        if rules is None:
            # Activations shard over the data axes only (the residual
            # stream replicates across "model"), so the reserve divides by
            # the data extent.
            data_n = max(1, mesh.size() // sizes.get("model", 1))
            rules = arch_rules(
                cfg, mesh,
                act_bytes=activation_footprint(cfg, shape, train.remat)
                // data_n)
        rules = with_batch_guard(rules, mesh, shape.global_batch)
        rules = resolve_collectives(rules, train.collectives)
        p_shard = param_shardings(mesh, rules, model.param_specs())
        b_shard = {k: placements(mesh, rules.act_spec(v))
                   for k, v in batch_logical_axes(cfg, "train").items()}

        @contextlib.contextmanager
        def scope():
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with use_mesh_rules(mesh, rules), implicit_replication():
                yield

    def loss_fn(params, batch):
        cast = tree_map(lambda p: p.to(compute_dtype)
                        if p.dtype == torch.float32 else p, params)
        with scope():
            return model.loss(cast, batch, dtype=compute_dtype)

    def grads(loss, leaves):
        with scope():        # remat recomputes the forward in here
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = []
        for g, p in zip(gs, leaves):
            if g is None:
                g = torch.zeros_like(p)
            elif isinstance(p, DTensor) and \
                    tuple(g.placements) != tuple(p.placements):
                # The data-parallel reduction: partial sums to the
                # parameter's placements.
                g = g.redistribute(p.device_mesh, p.placements)
            out.append(g)
        return out

    def microbatch(part):
        """Microbatch rows of the global batch, on the batch placements."""
        if mesh is None:
            return part
        return {k: v if tuple(v.placements) == tuple(b_shard[k])
                else v.redistribute(mesh, b_shard[k])
                for k, v in part.items()}

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        if mb <= 1:
            loss, metrics = loss_fn(params, batch)
            g = grads(loss, leaves)
            return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                    g)
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        lsum = None
        parts = {k: v.chunk(mb, dim=1 if k == "positions_3d" else 0)
                 for k, v in batch.items()}
        for i in range(mb):
            loss, _ = loss_fn(params, microbatch(
                {k: v[i] for k, v in parts.items()}))
            for acc, g in zip(gsum, grads(loss, leaves)):
                acc.add_(g)
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        loss = lsum / mb
        return (loss, {"nll": loss, "aux": torch.zeros_like(loss)},
                [g / mb for g in gsum])

    def step_fn(params, opt_state, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, metrics, g = grads_of(params, batch)
        with torch.no_grad(), scope():
            g = tree_unflatten(params, g)
            if train.grad_compression != "none":
                wire, scales, _ = compress_gradient(g, train.grad_compression)
                g = decompress_gradient(wire, train.grad_compression, scales)
            new_params, new_opt, opt_metrics = adamw_update(
                params, g, opt_state, train)
        for p in tree_leaves(new_params):
            p.requires_grad_(True)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_params, new_opt, {k: _full(v) for k, v in metrics.items()}

    return TrainStep(fn=step_fn, model=model, device=device, mesh=mesh,
                     rules=rules, param_sharding=p_shard,
                     batch_sharding=b_shard)


def init_train_state(ts: TrainStep, seed: int, train: TrainConfig
                     ) -> Tuple[PyTree, OptState]:
    """Seeded float32 parameters (leaves that require grad) and AdamW's
    zero state in ``train.optimizer_dtype``.  On a mesh each leaf is a
    DTensor with its placements, holding the values of the one-device
    ``Model.init(seed)``: every rank draws a leaf whole and keeps its shard
    before the next is drawn, so the whole model is never held at once
    (the reference draws the shards directly; the port's seeded generator
    draws whole leaves)."""
    place = None
    if ts.mesh is not None:
        def place(path, leaf):
            pl = ts.param_sharding
            for k in path.split("."):
                pl = pl[k]
            return distribute(leaf, ts.mesh, pl)

    params = ts.model.init(seed, device=ts.device, dtype=torch.float32,
                           place=place)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params, state_dtype=_dtype(train.optimizer_dtype))
    return params, opt


# ---------------------------------------------------------------------------
# Training loop with the FT substrate
# ---------------------------------------------------------------------------


class Trainer:
    def __init__(self, run: RunConfig, mesh=None, device=None):
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.ft import (PreemptionHandler, StepWatchdog,
                                    StragglerPolicy)

        self.run = run
        self.mesh = mesh
        self.ts = make_train_step(run.model, run.shape, mesh, run.train,
                                  device=None if mesh is not None else device)
        self.device = self.ts.device
        self.ckpt = CheckpointManager(run.train.checkpoint_dir,
                                      keep=run.train.keep_checkpoints)
        self.preempt = PreemptionHandler().install()
        self.straggler = StragglerPolicy()
        self.watchdog = StepWatchdog(
            deadline_s=300.0,
            on_timeout=lambda step, dt: print(
                f"[ft] step {step} exceeded deadline ({dt:.1f}s)"))
        self.step = 0
        self.params = None
        self.opt = None

    # ---------------------------------------------------------------- state
    def init_or_restore(self) -> int:
        self.params, self.opt = init_train_state(
            self.ts, self.run.train.seed, self.run.train)
        restored, manifest = self._try_restore()
        if restored is not None:
            self.params, self.opt = restored
            self.step = manifest["step"]
            print(f"[ckpt] resumed from step {self.step}")
        return self.step

    def _try_restore(self):
        """Restore by name onto this trainer's mesh or device: each leaf is
        distributed to the placements the current step gives it, whatever
        mesh wrote the checkpoint (elastic restore).  Every rank reads the
        directory itself, so the ranks first agree on the checkpoint: one
        that sees another (no shared filesystem, a save cut short) makes
        every rank raise, rather than hold shards of different states."""
        from repro_torch.ckpt import to_tensor

        if self.mesh is not None and _world() > 1:
            views = [None] * _world()
            dist.all_gather_object(views, self.ckpt.latest_manifest())
            if any(v != views[0] for v in views):
                raise RuntimeError(
                    f"the ranks see different checkpoints in "
                    f"{self.run.train.checkpoint_dir}: steps "
                    f"{[v and v['step'] for v in views]} by rank")
        template = (self.params, self.opt)
        flat = tree_flatten_with_paths(template)

        def reshard(key, arr):
            like = flat[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                    f"the model's {tuple(like.shape)}: "
                    f"{self.run.train.checkpoint_dir} holds another run")
            t = to_tensor(arr, self.device, like.dtype)
            if isinstance(like, DTensor):
                t = distribute(t, like.device_mesh, like.placements)
            return t.requires_grad_(like.requires_grad)

        out, manifest = self.ckpt.restore_latest(template, reshard=reshard)
        return (out, manifest) if out is not None else (None, None)

    # ----------------------------------------------------------------- loop
    def _stop_requested(self) -> bool:
        """The preemption flag, agreed by every rank: a signal that reaches
        one rank stops them all before the same step (the final save
        gathers the sharded leaves, a collective every rank must join)."""
        stop = self.preempt.should_stop
        if self.mesh is None or _world() == 1:
            return stop
        flag = torch.tensor([int(stop)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def fit(self, steps: int, data_iter, log_every: int = 10
            ) -> Dict[str, list]:
        history = {"loss": [], "step_time": []}
        target = self.step + steps
        while self.step < target:
            if self._stop_requested():
                print("[ft] preemption requested: final checkpoint + drain")
                self.ckpt.save(self.step, (self.params, self.opt),
                               blocking=True)
                break
            step_idx, host_batch = next(data_iter)
            batch = self.ts.place_batch(host_batch)
            self.watchdog.start_step(self.step)
            t0 = time.perf_counter()
            self.params, self.opt, metrics = self.ts.fn(
                self.params, self.opt, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.watchdog.end_step()
            self.straggler.record(0, dt)
            history["loss"].append(loss)
            history["step_time"].append(dt)
            self.step += 1
            if log_every and self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            if self.step % self.run.train.checkpoint_every == 0:
                self.ckpt.save(self.step, (self.params, self.opt))
        self.ckpt.wait()
        return history
