"""Paged serving on one card: plan-sized KV pages, slot-level continuous
batching and chunked prefill (the port of ``repro.serve``)."""

from repro_torch.serve.engine import ServeEngine, ServePolicy, plan_decode
from repro_torch.serve.sampling import SamplingConfig

__all__ = ["SamplingConfig", "ServeEngine", "ServePolicy", "plan_decode"]
