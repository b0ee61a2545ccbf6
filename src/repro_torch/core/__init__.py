"""The paper's run-time decomposition against the H100's hierarchy:
distributions, Algorithm 1, the hierarchy and the decode planner walk."""

from repro_torch.core.decompose import (NoValidDecomposition, find_optimal_np,
                                        make_phi_mesh, validate_np)
from repro_torch.core.distribution import (Array1DDistribution, Distribution,
                                           ReplicatedDistribution)
from repro_torch.core.hierarchy import MemoryLevel, h100_hierarchy
from repro_torch.core.plan import (HierarchicalPlan, LevelPlan, PlanPolicy,
                                   Workload, plan_run, quantize_divisor)

__all__ = [k for k in dir() if not k.startswith("_")]
