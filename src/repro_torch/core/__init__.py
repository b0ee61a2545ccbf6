"""Cache-Conscious Run-time Decomposition (Paulino & Delgado, 2015), the
core of the port:

  * ``hierarchy``    -- the memory-hierarchy model (§3.1): the host's
                        caches read from sysfs, the paper's two systems,
                        and one H100's levels
  * ``distribution`` -- the Distribution<T> interface (Table 1)
  * ``decompose``    -- Algorithm 1, the search for np, the phi functions
                        (§2.1) and the ``Decomposer``
  * ``schedule``     -- CC / SRRC task clustering (§2.2), LLSC affinity
                        (§2.3)
  * ``engine``       -- the synchronization-free execution engine (§2.4),
                        host code over OS threads
  * ``plan``         -- the recursive planner over a whole hierarchy
  * ``autotile``     -- the planner's SMEM-level kernel tiles
"""

from repro_torch.core.decompose import (Decomposer, DecompositionPlan,
                                        NoValidDecomposition, find_optimal_np,
                                        make_phi_mesh, make_phi_smem,
                                        phi_conservative, phi_simple,
                                        validate_np)
from repro_torch.core.distribution import (Array1DDistribution,
                                           Array2DBlockDistribution,
                                           CompositeDomain, Distribution,
                                           ReplicatedDistribution,
                                           RowBlockDistribution,
                                           StencilDistribution, matmul_domain,
                                           matmul_task_grid)
from repro_torch.core.engine import Engine, RunResult, StageTimes
from repro_torch.core.hierarchy import (MemoryLevel, h100_hierarchy,
                                        paper_system_a, paper_system_i,
                                        read_linux_hierarchy)
from repro_torch.core.plan import (HierarchicalPlan, LevelPlan, PlanError,
                                   PlanPolicy, Workload, plan_run,
                                   quantize_divisor)
from repro_torch.core.schedule import (cc_range, cc_schedule, cc_worker_tasks,
                                       grid_order,
                                       lowest_level_shared_cache_groups,
                                       ring_stream_order, srrc_cluster_size,
                                       srrc_schedule, srrc_worker_tasks)

__all__ = [k for k in dir() if not k.startswith("_")]
