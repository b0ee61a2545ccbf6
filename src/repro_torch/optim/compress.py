"""Gradient compression (the port of ``repro.optim.compress``).

  * ``bf16``    -- gradients cast to bfloat16 on the wire, back to float32.
  * ``int8_ef`` -- per-tensor symmetric int8 quantization with error
                   feedback: the quantization residual (bfloat16) is carried
                   to the next step.

In the reference these shape what its data-parallel all-reduce carries; on
one card there is no reduce, and the train step only rounds the gradients
through the wire format.  ``int8_ef`` needs the error-feedback state, which
the reference's step does not pass (``compress_gradient`` raises there, as
the reference asserts).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_map, tree_unzip

PyTree = Any


def ef_state_init(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)


def compress_gradient(grads: PyTree, scheme: str, ef: Optional[PyTree] = None
                      ) -> Tuple[PyTree, Optional[PyTree], Optional[PyTree]]:
    """Returns ``(wire_grads, scales, new_ef)``."""
    if scheme == "none":
        return grads, None, ef
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), None, ef
    if scheme == "int8_ef":
        if ef is None:
            raise ValueError("int8_ef compression needs the error-feedback "
                             "state (ef_state_init)")

        def q(g, e):
            g32 = g.float() + e.float()
            scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
            qi = torch.clamp(torch.round(g32 / scale), -127, 127).to(
                torch.int8)
            resid = g32 - qi.float() * scale
            return qi, scale, resid.to(torch.bfloat16)

        return tree_unzip(tree_map(q, grads, ef), 3)
    raise ValueError(f"unknown compression scheme {scheme!r}")


def decompress_gradient(wire: PyTree, scheme: str,
                        scales: Optional[PyTree] = None) -> PyTree:
    if scheme == "none":
        return wire
    if scheme == "bf16":
        return tree_map(lambda g: g.float(), wire)
    if scheme == "int8_ef":
        return tree_map(lambda qi, s: qi.float() * s, wire, scales)
    raise ValueError(scheme)
