"""GPipe-style microbatch pipeline over one mesh axis (the port of
``repro.dist.pipeline``).

The mesh axis is a ring of pipeline stages: stage parameters carry a
leading stage dimension (each rank runs its own slice), microbatches enter
at stage 0 and activations hop one stage a step by point-to-point transfer
(``torch.distributed.batch_isend_irecv`` on the axis's process group).
With ``M`` microbatches and ``P`` stages the schedule runs ``M + P - 1``
steps -- the GPipe trapezoid -- and every rank computes its stage for a
different microbatch at every interior step.  The forward only: the
reference calls it from tests alone, and the port adds no gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def dcn_stages(plan) -> int:
    """Stage count the hierarchical plan's DCN sub-plan prescribes (1 when
    the plan is None or has no DCN level)."""
    lp = plan.level("DCN") if plan is not None else None
    return lp.np if lp is not None else 1


def make_pipeline(mesh, stage_fn: Callable[[PyTree, torch.Tensor],
                                           torch.Tensor],
                  axis: str = "pod", plan: Optional[Any] = None):
    """Build ``fn(stage_params, microbatches) -> outputs``.

    ``stage_params`` is a tree whose leaves carry a leading stage dimension
    equal to the ``axis`` size, and ``microbatches`` an ``(n_microbatches,
    ...)`` stack, both the same on every rank.  Every rank returns the
    outputs: the stages
    applied in order (stage order = position along the mesh axis) to every
    microbatch.  Shapes must be stage-invariant (GPipe homogeneity).

    ``plan`` (a ``HierarchicalPlan``) maps the stages onto the planner's
    DCN sub-plan: when the plan partitioned the DCN level, the mesh axis
    must realize exactly that stage count."""
    n_stages = dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]
    if plan is not None:
        want = dcn_stages(plan)
        if want > 1 and want != n_stages:
            raise ValueError(
                f"plan's DCN sub-plan prescribes {want} stages but mesh "
                f"axis {axis!r} has {n_stages}")
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
    prv = dist.get_global_rank(group, (idx - 1) % n_stages)

    @torch.no_grad()
    def pipeline(stage_params: PyTree, microbatches: torch.Tensor
                 ) -> torch.Tensor:
        for leaf in tree_leaves(stage_params):
            if leaf.shape[0] != n_stages:
                raise ValueError(
                    f"leading stage dim {leaf.shape[0]} != mesh axis "
                    f"{axis!r} size {n_stages}")
        params = tree_map(lambda a: a[idx], stage_params)  # my stage
        mbs = microbatches
        n_mb = mbs.shape[0]
        outputs = torch.zeros_like(mbs)
        carry = torch.zeros_like(mbs[0])
        for t in range(n_mb + n_stages - 1):
            # Stage 0 injects microbatch t; later stages consume the carry
            # their predecessor forwarded last step.
            feed = mbs[min(t, n_mb - 1)] if idx == 0 else carry
            y = stage_fn(params, feed)
            if y.shape != mbs.shape[1:] or y.dtype != mbs.dtype:
                raise ValueError(
                    f"stage output {tuple(y.shape)}/{y.dtype} must match "
                    f"microbatch {tuple(mbs.shape[1:])}/{mbs.dtype} "
                    f"(GPipe homogeneity)")
            # The last stage retires microbatch t - (P-1) once it is valid.
            t_out = t - (n_stages - 1)
            if idx == n_stages - 1 and 0 <= t_out < n_mb:
                outputs[t_out] = y
            if n_stages > 1:
                y = y.contiguous()
                carry = torch.empty_like(y)
                for r in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, y, nxt, group),
                        dist.P2POp(dist.irecv, carry, prv, group)]):
                    r.wait()
        # Only the tail stage wrote real values; share them with the ring.
        if n_stages > 1:
            dist.all_reduce(outputs, group=group)
        return outputs

    return pipeline
