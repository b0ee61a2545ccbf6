"""Distribution across devices (the port of ``repro.dist``).  So far only
the plan-time ring schedule of ``dist.overlap`` (``RingPlan``,
``plan_ring``), which the cluster's page transfer order reads; the ring
collective matmuls over NCCL come with the distribution slice."""

from repro_torch.dist.overlap import MODES, RingPlan, plan_ring

__all__ = ["MODES", "RingPlan", "plan_ring"]
