"""``repro_torch.plan``: the recursive planner's import surface (see
``repro_torch.core.plan``), the counterpart of ``repro.plan``::

    from repro_torch.plan import HierarchicalPlan, PlanPolicy, Workload, \
        plan_run
"""

from repro_torch.core.plan import (  # noqa: F401
    MESH_LEVEL_NAMES,
    HierarchicalPlan,
    LevelPlan,
    PlanError,
    PlanPolicy,
    Workload,
    leaf_matmul_plan,
    plan_run,
    quantize_divisor,
)

__all__ = [
    "MESH_LEVEL_NAMES",
    "HierarchicalPlan",
    "LevelPlan",
    "PlanError",
    "PlanPolicy",
    "Workload",
    "leaf_matmul_plan",
    "plan_run",
    "quantize_divisor",
]
