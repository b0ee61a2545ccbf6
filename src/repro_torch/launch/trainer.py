"""The training step factory and the training loop (the port of
``repro.launch.trainer`` on one card).

``make_train_step`` builds the step: the float32 parameters cast to the
compute dtype inside the loss, ``Model.loss`` differentiated by
``torch.autograd``, gradient accumulation over equal microbatches of the
batch (gradients summed in float32 and divided by their count), the
gradient compression's round trip when one is set, then AdamW.  It is the
reference's ``step_fn`` without its sharding: the parameters, moments and
batch live on one device, so there are no shardings to build and no
collectives to schedule -- ``TrainConfig.collectives`` accepts the
reference's default ``"gspmd"`` and ignores it.  The reference's
``arch_rules``, ``activation_footprint`` and batch guard belong to its
distribution layer, which the port has not yet.

The parameters are leaf tensors that require grad.  The update runs under
``torch.no_grad()`` and rebinds: ``adamw_update`` returns new parameter
and moment tensors, and the step hands back the new parameters as leaves
that require grad.

``Trainer`` wires the fault-tolerance substrate as the reference does:
async keep-k checkpoints (the reference's format), the preemption drain,
the step watchdog and the straggler policy, and restore-by-name onto the
trainer's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig, TrainConfig
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


@dataclass
class TrainStep:
    fn: Callable              # (params, opt, batch) -> (params, opt, metrics)
    model: Model
    device: torch.device


def make_train_step(cfg, shape, train: TrainConfig = TrainConfig(),
                    device=None) -> TrainStep:
    """The train step for ``cfg`` on ``device`` (default the card).
    ``shape`` is the batch the step takes; its global batch must split
    into ``train.microbatches`` equal microbatches."""
    device = resolve_device(device)
    if train.collectives != "gspmd":
        raise NotImplementedError(
            f"collectives={train.collectives!r} schedules the reference's "
            "tensor-parallel collectives; the port runs on one card")
    mb = max(1, train.microbatches)
    if shape.global_batch % mb:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {mb} microbatches")
    model = Model(cfg, remat=train.remat)
    compute_dtype = _dtype(train.dtype)

    def loss_fn(params, batch):
        cast = tree_map(lambda p: p.to(compute_dtype)
                        if p.dtype == torch.float32 else p, params)
        return model.loss(cast, batch, dtype=compute_dtype)

    def grads(loss, leaves):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(gs, leaves)]

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        if mb <= 1:
            loss, metrics = loss_fn(params, batch)
            g = grads(loss, leaves)
            return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                    g)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        parts = {k: v.chunk(mb, dim=1 if k == "positions_3d" else 0)
                 for k, v in batch.items()}
        for i in range(mb):
            loss, _ = loss_fn(params, {k: v[i] for k, v in parts.items()})
            for acc, g in zip(gsum, grads(loss, leaves)):
                acc.add_(g)
            lsum = lsum + loss.detach()
        loss = lsum / mb
        return (loss, {"nll": loss, "aux": torch.zeros_like(loss)},
                [g / mb for g in gsum])

    def step_fn(params, opt_state, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, metrics, g = grads_of(params, batch)
        with torch.no_grad():
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
        return new_params, new_opt, metrics

    return TrainStep(fn=step_fn, model=model, device=device)


def init_train_state(ts: TrainStep, seed: int, train: TrainConfig
                     ) -> Tuple[PyTree, OptState]:
    """Seeded float32 parameters on the step's device (leaves that require
    grad) and AdamW's zero state in ``train.optimizer_dtype``: the
    counterpart of the reference's ``init_sharded_state``."""
    params = ts.model.init(seed, device=ts.device, dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, adamw_init(params,
                              state_dtype=_dtype(train.optimizer_dtype))


# ---------------------------------------------------------------------------
# Training loop with the FT substrate
# ---------------------------------------------------------------------------


class Trainer:
    def __init__(self, run: RunConfig, device=None):
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.ft import (PreemptionHandler, StepWatchdog,
                                    StragglerPolicy)

        self.run = run
        self.device = resolve_device(device)
        self.ts = make_train_step(run.model, run.shape, run.train,
                                  self.device)
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
        from repro_torch.ckpt import to_tensor

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
            return t.requires_grad_(like.requires_grad)

        out, manifest = self.ckpt.restore_latest(template, reshard=reshard)
        return (out, manifest) if out is not None else (None, None)

    # ----------------------------------------------------------------- loop
    def fit(self, steps: int, data_iter, log_every: int = 10
            ) -> Dict[str, list]:
        history = {"loss": [], "step_time": []}
        target = self.step + steps
        while self.step < target:
            if self.preempt.should_stop:
                print("[ft] preemption requested: final checkpoint + drain")
                self.ckpt.save(self.step, (self.params, self.opt),
                               blocking=True)
                break
            step_idx, host_batch = next(data_iter)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in host_batch.items()}
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
