"""``repro_torch`` -- the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The module layout mirrors ``repro`` so each port module sits where its
counterpart does (``repro_torch.serve.engine`` <-> ``repro.serve.engine``).
The port imports ``torch`` and never ``jax``, and nothing of ``repro``: what
it needs from there (configs, the planner walk, obs) it keeps as its own
copy.

Its one hand-written Hopper kernel so far is paged attention
(``csrc/paged_attention.cu``, wrapped by ``kernels.paged_attention``).
Entry points take ``device=None``, meaning ``"cuda"``; pass ``"cpu"`` to run
the plain PyTorch versions of the kernels instead (the CPU tests do).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Asking for CUDA on a machine without it raises instead of quietly
    running on the CPU -- a CPU run has to be asked for by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device (none is available); pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
