"""Serving on one card (the port of ``repro.serve``): plan-sized KV pages,
slot-level continuous batching with chunked prefill over a page pool, and
cohort batching over contiguous caches."""

from repro_torch.serve.engine import ServeEngine, ServePolicy, plan_decode
from repro_torch.serve.sampling import SamplingConfig

__all__ = ["SamplingConfig", "ServeEngine", "ServePolicy", "plan_decode"]
