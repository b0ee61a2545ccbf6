"""AdamW with mixed-precision state, global-norm clipping and a warmup +
cosine schedule (the port of ``repro.optim.adamw``).

Pure functions over the parameter dict: the update returns new parameter
and moment tensors and changes nothing it is given.  The math is float32
whatever the leaves' dtypes; the moments are stored in ``state_dtype``
(bfloat16 roughly halves the optimizer's memory).  Call them under
``torch.no_grad()`` (the train step does).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unzip

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: PyTree                 # first moment
    nu: PyTree                 # second moment


def adamw_init(params: PyTree, state_dtype=torch.float32) -> OptState:
    def zeros(p):        # a DTensor parameter gets moments of its placements
        return torch.zeros_like(p, dtype=state_dtype,
                                memory_format=torch.contiguous_format)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``learning_rate`` over ``warmup_steps``, then a
    cosine to a tenth of it at ``total_steps``."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return cfg.learning_rate * warm * (0.1 + 0.9 * cos)
    return fn


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / |g|)`` (``|g|`` the
    float32 norm over all leaves); returns ``(grads, |g|)``."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw_update(params: PyTree, grads: PyTree, state: OptState, cfg
                 ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: clip, advance ``step``, then per leaf the float32
    moments, bias corrections and decoupled weight decay at the scheduled
    rate.  Returns ``(new_params, new_state, {"lr", "grad_norm"})``, each
    leaf in its input's dtype."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg)(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = m.float() * b1 + (1 - b1) * g32
        v32 = v.float() * b2 + (1 - b2) * g32.square()
        p32 = p.float()
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + 1e-8) \
            + cfg.weight_decay * p32
        return (p32 - lr * u).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    new_params, mu, nu = tree_unzip(
        tree_map(upd, params, grads, state.mu, state.nu), 3)
    return new_params, OptState(step, mu, nu), {"lr": lr, "grad_norm": gnorm}

