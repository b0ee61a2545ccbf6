"""Seeded weights, drawn on the device in the type they are served in.

The program declares its parameter tree (path, shape, axes, init, scale);
the benchmark draws it.  Every normal leaf is a view into one flat buffer
filled by a single ``normal_`` from a generator on the device, then scaled
in place: fan-in scaled (``scale / sqrt(fan_in)``, the fan-in the first dim
that is not a stacking axis), or 0.02 for the embedding.  Norm weights are
ones.  The same seed gives the same weights, and both the program and the
reference read these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from bench.traffic import seed_bits

STACK_AXES = ("layers", "experts")

Spec = Tuple[Tuple[int, ...], Tuple, str, float]   # shape, axes, init, scale


def std_of(shape, axes, init: str, scale: float) -> float:
    if init == "embed":
        return 0.02 * scale
    fan = [n for n, a in zip(shape, axes) if a not in STACK_AXES]
    return scale / math.sqrt(max(1, fan[0] if fan else shape[0]))


def make(specs: Dict[str, Spec], seed: int, device, dtype=torch.bfloat16
         ) -> dict:
    """The nested weight tree of ``specs`` (dotted path -> spec)."""
    drawn = {p: s for p, s in specs.items() if s[2] in ("normal", "embed")}
    total = sum(math.prod(s[0]) for s in drawn.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, (shape, axes, init, scale) in specs.items():
        if path in drawn:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape).mul_(
                std_of(shape, axes, init, scale))
            off += n
        elif init in ("ones", "zeros"):
            leaf = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"{path}: unknown init {init!r}")
        node = tree
        *parents, name = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree
