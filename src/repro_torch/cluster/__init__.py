"""Multi-replica serving over the DCN level (the port of
``repro.cluster``).

The planner's outermost consumer: ``plan_decode(cfg, cluster=N)`` grows a
DCN level whose realized ``np`` is the fleet width, each replica hosts
one single-card ``ServeEngine`` (the plan's subtree below DCN), and the
router places each request by the memory-aware ``free_pages`` policy with
prefix affinity.  ``disagg`` splits the fleet into prefill and decode
roles with ring-ordered KV page streaming between them; ``http`` is the
stdlib streaming front end.  Replicas that share one card split its HBM
by ``replica_kv_budget``.
"""

from repro_torch.cluster.disagg import (DisaggCluster, KVTransfer,
                                        PageStreamReceiver, export_transfer,
                                        import_transfer, transfer_order)
from repro_torch.cluster.http import ClusterServer
from repro_torch.cluster.router import (POLICIES, ClusterRequest, Router,
                                        ServeCluster, plan_stats)
from repro_torch.cluster.worker import (CONTEXT_BYTES, EngineSpec, Replica,
                                        ReplicaStats, StubSpec,
                                        cuda_context_bytes,
                                        replica_kv_budget)

__all__ = [
    "CONTEXT_BYTES",
    "POLICIES",
    "ClusterRequest",
    "ClusterServer",
    "DisaggCluster",
    "EngineSpec",
    "KVTransfer",
    "PageStreamReceiver",
    "Replica",
    "ReplicaStats",
    "Router",
    "ServeCluster",
    "StubSpec",
    "cuda_context_bytes",
    "export_transfer",
    "import_transfer",
    "plan_stats",
    "replica_kv_budget",
    "transfer_order",
]
