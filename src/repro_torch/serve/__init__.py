"""Serving on one card (the port of ``repro.serve``): plan-sized KV pages,
slot-level continuous batching with chunked prefill over a page pool, the
radix prefix cache over that pool, and cohort batching over contiguous
caches."""

from repro_torch.serve.engine import ServeEngine, ServePolicy, plan_decode
from repro_torch.serve.kvcache import (
    PageSpec,
    align_capacity,
    grow_cache,
    kv_token_bytes,
    page_spec_from_plan,
    request_state_bytes,
)
from repro_torch.serve.pages import (
    PAGED_FAMILIES,
    PagePool,
    PagedScheduler,
    init_paged_cache,
    paged_cache_logical_axes,
    reset_slot,
)
from repro_torch.serve.prefix import (
    PREFIX_FAMILIES,
    PrefixHit,
    RadixPrefixCache,
)
from repro_torch.serve.sampling import SamplingConfig, sample
from repro_torch.serve.scheduler import Request, ServeScheduler
from repro_torch.serve.steps import (
    PagedServeSteps,
    ServeSteps,
    make_paged_steps,
    make_serve_steps,
)

__all__ = [
    "PAGED_FAMILIES",
    "PREFIX_FAMILIES",
    "PagePool",
    "PagedScheduler",
    "PagedServeSteps",
    "PageSpec",
    "PrefixHit",
    "RadixPrefixCache",
    "Request",
    "SamplingConfig",
    "ServeEngine",
    "ServePolicy",
    "ServeScheduler",
    "ServeSteps",
    "align_capacity",
    "grow_cache",
    "init_paged_cache",
    "kv_token_bytes",
    "make_paged_steps",
    "make_serve_steps",
    "page_spec_from_plan",
    "paged_cache_logical_axes",
    "plan_decode",
    "request_state_bytes",
    "reset_slot",
    "sample",
]
