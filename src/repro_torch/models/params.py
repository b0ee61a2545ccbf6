"""Declarative parameter specs -> tensors (the port of
``repro.models.params``).

Every parameter is a ``ParamSpec(shape, axes, init)`` in a nested dict; a
leading ``"layers"`` axis stacks the homogeneous layers, exactly as in the
JAX package, so one parameter tree has the same paths and shapes in both
packages.  ``init_params`` draws seeded weights; ``params_from_numpy``
carries the JAX package's parameters, handed over as numpy arrays, into the
port -- how the parity tests make both packages compute the same thing.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

PyTree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # multiplier on the fan-in init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec_tree_map(fn: Callable[[str, ParamSpec], Any], specs: PyTree,
                  prefix: str = "") -> PyTree:
    """Map over a nested dict of ParamSpecs, passing the dotted path."""
    if isinstance(specs, ParamSpec):
        return fn(prefix, specs)
    return {
        k: spec_tree_map(fn, v, f"{prefix}.{k}" if prefix else k)
        for k, v in specs.items()
    }


def _leaf_seed(seed: int, path: str) -> int:
    # Python salts ``hash(str)`` per process (the reference seeds leaves
    # with it); crc32 gives every leaf the same stream in every process.
    return (int(seed) * 0x9E3779B1 + zlib.crc32(path.encode())) & (2**63 - 1)


def init_params(specs: PyTree, seed: int, device, dtype=torch.float32
                ) -> PyTree:
    """Seeded weights on ``device``: fan-in scaled normals (``embed``: std
    0.02), ones/zeros where the spec says.  Each leaf draws from its own
    ``torch.Generator`` on ``device``, seeded from ``seed`` and its path,
    into a tensor of ``dtype``: a leaf stacked over ``"layers"`` one layer
    at a time, any other leaf whole, each draw made in float32 and cast.
    (Drawn whole, Mixtral's stacked ``moe.wi`` at 24 layers would take
    45 GB of float32 beside the weights.)"""
    device = torch.device(device)

    def one(path: str, spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, device=device, dtype=dtype)
        if spec.init == "ones":
            return torch.ones(spec.shape, device=device, dtype=dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(_leaf_seed(seed, path))
        if spec.init == "embed":
            std = 0.02 * spec.scale
        else:
            # fan-in scaled; ignore leading stack axes ("layers", "experts")
            fan_dims = [s for s, a in zip(spec.shape, spec.axes)
                        if a not in ("layers", "experts")]
            fan_in = fan_dims[0] if fan_dims else spec.shape[0]
            std = spec.scale / math.sqrt(max(1, fan_in))
        out = torch.empty(spec.shape, device=device, dtype=dtype)
        for part in (out if spec.axes[0] == "layers" else out[None]):
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32).mul_(std))
        return out

    return spec_tree_map(one, specs)


def params_from_numpy(tree: PyTree, cfg, device, dtype=torch.float32
                      ) -> PyTree:
    """The JAX package's parameter tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) as the port's tensors on ``device``.

    Paths and shapes are checked against the port's own specs for ``cfg``,
    so a layout drift between the packages fails here, not as a wrong
    number later."""
    from repro_torch.models.model import Model

    specs = Model(cfg).param_specs()
    device = torch.device(device)

    def one(path: str, spec: ParamSpec):
        node = tree
        for k in path.split("."):
            if not isinstance(node, dict) or k not in node:
                raise KeyError(f"parameter {path!r} missing from the tree")
            node = node[k]
        arr = np.array(node, dtype=np.float32)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"parameter {path!r}: shape {arr.shape} != "
                             f"spec {spec.shape}")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return spec_tree_map(one, specs)

