"""Distribution layer: the device mesh as the outermost memory level (the
port of ``repro.dist``).

  * ``sharding``  -- logical-axis sharding rules (as DTensor placements)
    where the FSDP / TP / replicated choice is made by the paper's
    Algorithm 1 against one card's HBM, not by a hand-written table.
  * ``overlap``   -- ring / serpentine all-gather and reduce-scatter
    matmuls that stream mesh-level partitions over the interconnect while
    ``matmul_cc`` runs the resident one (the CC/SRRC "compute the resident
    partition while fetching the next" idea lifted to NVLink).
  * ``pipeline``  -- GPipe-style microbatch schedule over a mesh axis.
"""

from repro_torch.dist.overlap import (  # noqa: F401
    MODES,
    RingPlan,
    make_ag_matmul,
    make_ag_matmul_fused,
    make_rs_matmul,
    overlap_matmul,
    plan_ring,
)
from repro_torch.dist.pipeline import dcn_stages, make_pipeline  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    COLLECTIVES,
    ShardingRules,
    active_overlap,
    active_rule,
    arch_rules,
    constrain,
    default_rules,
    logical_sharding,
    mesh_decomposition,
    mesh_plan,
    param_shardings,
    use_mesh_rules,
    with_batch_guard,
    with_collectives,
)

__all__ = [
    "COLLECTIVES",
    "MODES",
    "RingPlan",
    "ShardingRules",
    "active_overlap",
    "active_rule",
    "arch_rules",
    "constrain",
    "dcn_stages",
    "default_rules",
    "logical_sharding",
    "make_ag_matmul",
    "make_ag_matmul_fused",
    "make_pipeline",
    "make_rs_matmul",
    "mesh_decomposition",
    "mesh_plan",
    "overlap_matmul",
    "param_shardings",
    "plan_ring",
    "use_mesh_rules",
    "with_batch_guard",
    "with_collectives",
]
