"""The system under test, and the one module of the benchmark that imports
it: the PyTorch/CUDA port ``repro_torch``.

From the program the benchmark takes the engine it drives, its parameter
layout, its counters and its spans.  A configuration file's ``port`` block
holds the port's ``ModelConfig`` as the cell runs it.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.weights import Spec


def model_config(cfg: dict):
    """The port's ``ModelConfig`` from a configuration file."""
    from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

    p = dict(cfg["port"])
    moe, mla = p.pop("moe", None), p.pop("mla", None)
    return ModelConfig(arch=cfg["name"], **p,
                       moe=MoEConfig(**moe) if moe else None,
                       mla=MLAConfig(**mla) if mla else None,
                       source=cfg["source"])


def param_specs(cfg: dict) -> Dict[str, Spec]:
    """The port's parameter tree as ``path -> (shape, axes, init,
    scale)``."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import spec_tree_map

    out: Dict[str, Spec] = {}

    def one(path, s):
        out[path] = (tuple(s.shape), tuple(s.axes), s.init, float(s.scale))

    spec_tree_map(one, Model(model_config(cfg)).param_specs())
    return out


class Engine:
    """The paged serving engine as a cell runs it: chunked prefill, no
    prefix cache, greedy tokens, ``clients`` decode slots of ``max_len``,
    bf16 weights and pool.  The pool holds every slot's longest request of
    the mix (its longest prompt and output, and the token the last chunk
    reserves for the first decode), so no request is preempted, and no
    more: ``pool_pages`` pages of ``page_bytes``."""

    def __init__(self, cfg: dict, mix: dict, params: dict, device):
        from repro_torch.serve.engine import (ServeEngine, ServePolicy,
                                              page_spec_from_plan,
                                              plan_decode)

        mcfg = model_config(cfg)
        slots, max_len = int(mix["clients"]), int(mix["max_len"])
        longest = (int(mix["prompt_tokens"]["max"])
                   + int(mix["output_tokens"]["max"]) + 1)
        page = page_spec_from_plan(
            plan_decode(mcfg, max_len=max_len, batch=slots, dtype_bytes=2),
            mcfg, 2)
        self.pool_pages = slots * page.pages_for(longest)
        self.page_bytes = page.page_bytes
        policy = ServePolicy(max_slots=slots, max_len=max_len,
                             batching="paged", prefill="chunked",
                             prefix_cache="off",
                             kv_budget_bytes=self.pool_pages * page.page_bytes)
        self.engine = ServeEngine(mcfg, policy, dtype=torch.bfloat16,
                                  params=params, device=device)
        if self.engine.page.page_tokens != page.page_tokens:
            raise RuntimeError("the engine planned another page than the "
                               "pool was sized for")
        self.chunk_tokens = int(self.engine.plan.chunk_tokens()
                                or self.engine.page.page_tokens)

    def generate(self, prompts, max_new: List[int], on_token) -> None:
        self.engine.generate(prompts, max_new_tokens=max_new,
                             on_token=on_token)

    def counters(self) -> Dict[str, float]:
        """Every number the engine's metrics registry holds (its counters,
        gauges and histograms' counts), by name."""
        obs = self.engine.obs
        return {k: obs.value(k) for k in obs.names()
                if isinstance(obs.value(k), (int, float))}

    def spans(self) -> List[dict]:
        """The engine's complete spans, on the host's monotonic clock."""
        from repro_torch.obs.trace import _EPOCH

        return [{"name": e["name"], "start": _EPOCH + e["ts"] / 1e6,
                 "end": _EPOCH + (e["ts"] + e["dur"]) / 1e6,
                 "args": e.get("args", {})}
                for e in self.engine.tracer.export_events()
                if e["ph"] == "X"]
