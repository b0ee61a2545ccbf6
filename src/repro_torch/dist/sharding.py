"""Logical-axis sharding rules, chosen by the paper's decomposer (the port
of ``repro.dist.sharding``).

Model code names *logical* axes ("embed", "heads", "batch", ...); a
``ShardingRules`` table maps each logical axis to zero or more mesh axes.
The FSDP / replicated choice for parameters is made by the paper's
Algorithm 1 (``find_optimal_np`` with ``phi_mesh``) against one card's HBM
in ``h100_hierarchy(mesh_devices=N)``, as the reference makes it against
one TPU chip's:

  * ``np* == 1``  -- the parameter + optimizer state fits each card after
    tensor parallelism: parameters replicate over the data axes.
  * ``np* > 1``   -- the state must be decomposed harder: parameters shard
    over the data axes (FSDP).

Tensor-parallel ("model" axis) rules are structural -- they follow from
the architecture's divisibilities (heads, experts, vocab).

A rule builds the port's own ``PartitionSpec``: one entry a tensor dim,
each None, a mesh axis name, or a tuple of them (major to minor), as in
JAX.  ``placements`` turns it into DTensor placements, one ``Shard(dim)``
or ``Replicate()`` a mesh dim; a tuple of mesh axes on one dim must follow
the mesh's own dim order, which is DTensor's major-to-minor order.

Functions that only read a mesh's axis names and sizes take anything with
``mesh_dim_names`` and ``shape`` (a ``DeviceMesh`` or an ``AbstractMesh``
below), so plans can be made for a 4 x 4 mesh with no process group.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from math import prod
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.decompose import (
    NoValidDecomposition,
    find_optimal_np,
    make_phi_mesh,
)
from repro_torch.core.distribution import (
    Array1DDistribution,
    ReplicatedDistribution,
)
from repro_torch.core.hierarchy import MemoryLevel
from repro_torch.core.plan import (
    HierarchicalPlan,
    PlanPolicy,
    Workload,
    plan_run,
)

AxisRule = Union[None, str, Tuple[str, ...]]
PyTree = Any

#: Resident bytes per parameter of the training state: fp32 master copy,
#: AdamW mu + nu (fp32 default), and the bf16 compute cast made each step.
TRAIN_STATE_BYTES_PER_PARAM = 4 + 4 + 4 + 2

#: Collective-matmul schedules the rules may request: "gspmd" leaves the
#: collectives to DTensor's sharding propagation; "ring"/"serpentine" route
#: the tensor-parallel projections through ``dist.overlap``'s rings.
COLLECTIVES = ("gspmd", "ring", "serpentine")


class PartitionSpec(tuple):
    """One entry a tensor dim: None, a mesh axis, or a tuple of mesh axes
    (major to minor) -- JAX's ``PartitionSpec`` as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group: what the
    plan-level functions read of a mesh."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (host arithmetic:
    nothing is allocated, not even on the meta device)."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(1, int(n))
    return tuple(reversed(out))


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_size(mesh) -> int:
    return prod(tuple(mesh.shape))


# ---------------------------------------------------------------------------
# Rules table
# ---------------------------------------------------------------------------


def _rule_axes(rule: AxisRule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def _entry(names: Sequence[str]) -> AxisRule:
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _build_spec(table: Dict[str, AxisRule],
                axes: Sequence[Optional[str]]) -> PartitionSpec:
    """PartitionSpec from logical axes via the table; a mesh axis is used at
    most once (the first logical axis wins, as in the reference)."""
    used: set = set()
    entries = []
    for ax in axes:
        names = [n for n in _rule_axes(table.get(ax) if ax else None)
                 if n not in used]
        used.update(names)
        entries.append(_entry(names))
    return P(*entries)


@dataclass
class ShardingRules:
    """Logical-axis -> mesh-axis tables for parameters and activations.

    ``meta`` carries the decomposer's provenance (mesh np*, budget, fit,
    the plan) and the collectives request; it is advisory, so callers may
    rebuild rules positionally (``ShardingRules(param_rules, act_rules)``).
    """

    param_rules: Dict[str, AxisRule]
    act_rules: Dict[str, AxisRule]
    meta: Dict[str, Any] = field(default_factory=dict)

    def param_spec(self, axes: Sequence[Optional[str]]) -> PartitionSpec:
        return _build_spec(self.param_rules, axes)

    def act_spec(self, axes: Sequence[Optional[str]]) -> PartitionSpec:
        return _build_spec(self.act_rules, axes)


# ---------------------------------------------------------------------------
# Mesh-level decomposition (Algorithm 1 at the outermost level)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshDecomposition:
    """Result of the mesh-level Algorithm 1 run."""

    np: int                    # smallest partition count that fits one HBM
    budget_bytes: int          # TCL_PER_CORE: one card's HBM
    granule_bytes: int         # sharding granule (the mesh "cache line")
    sharded_bytes: int         # state the search may partition
    replicated_bytes: int      # state pinned to every card
    fits: bool                 # False: even the max realizable np overflows

    @property
    def replicated(self) -> bool:
        return self.np <= 1


def mesh_hierarchy(mesh, spec=None) -> MemoryLevel:
    """The mesh in the paper's schema: [DCN ->] NVLINK -> HBM -> L2 ->
    SMEM -> REG.  A mesh with a "pod" axis gets a DCN level above the
    NVLINK level (one NVLINK domain a pod)."""
    from repro_torch.hw.h100 import h100_spec

    hosts = _axis_sizes(mesh).get("pod", 1)
    return (spec or h100_spec()).hierarchy(
        mesh_devices=_mesh_size(mesh) // max(1, hosts), hosts=hosts)


def mesh_plan(
    mesh,
    *,
    state_bytes: int = 0,
    act_bytes: int = 0,
    hierarchy: Optional[MemoryLevel] = None,
    max_np: Optional[int] = None,
    overhead: float = 1.0,
    matmul: Optional[Tuple[int, int, int]] = None,
    dtype_bytes: int = 2,
    spec=None,
) -> HierarchicalPlan:
    """``plan_run`` over this mesh's memory hierarchy: the DCN sub-plan
    (``dist.pipeline``'s stage count), the NVLINK sub-plan (the FSDP
    degree, raw and divisor-quantized) and, when ``matmul`` local shapes
    are given, the SMEM tile leaf.  ``max_np`` caps the NVLINK partition
    count (the FSDP capacity of the data axes); ``overhead`` is the
    architecture's ``phi_mesh`` transient-copy factor."""
    hierarchy = hierarchy or mesh_hierarchy(mesh, spec)
    caps = {"NVLINK": max_np} if max_np else {}
    return plan_run(
        hierarchy,
        Workload(state_bytes=state_bytes, replicated_bytes=act_bytes,
                 matmul=matmul, dtype_bytes=dtype_bytes, overhead=overhead),
        PlanPolicy(max_np=caps, spec=spec),
    )


def mesh_decomposition(
    hierarchy: MemoryLevel,
    sharded_bytes: int,
    replicated_bytes: int = 0,
    max_np: int = 1 << 16,
) -> MeshDecomposition:
    """Run Algorithm 1 with one card's HBM as the TCL: the planner's
    NVLINK node over the shardable training state (a 1-D byte range) plus
    a replicated remainder.  Returns the *raw* np.  The search is bounded
    by the smaller of ``max_np`` and the hierarchy's card count; when
    nothing fits it saturates at that bound with ``fits=False``."""
    hp = plan_run(
        hierarchy,
        Workload(state_bytes=sharded_bytes, replicated_bytes=replicated_bytes),
        PlanPolicy(max_np={"NVLINK": max_np, "DCN": max_np}, quantize=False),
    )
    lp = hp.level("NVLINK")
    if lp is None:
        # A hierarchy without an interconnect level: search it directly.
        hbm = hierarchy.find("HBM") or hierarchy
        budget = hbm.per_core_size()
        granule = hbm.cache_line_size or 8 * 128 * 4
        dists = [Array1DDistribution(length=max(1, sharded_bytes),
                                     element_size=1)]
        if replicated_bytes:
            dists.append(ReplicatedDistribution(replicated_bytes))
        try:
            np_ = find_optimal_np(budget, granule, dists, 1, make_phi_mesh(),
                                  max_np=max_np)
            fits = True
        except NoValidDecomposition:
            np_, fits = max_np, False
        return MeshDecomposition(
            np=np_, budget_bytes=budget, granule_bytes=granule,
            sharded_bytes=sharded_bytes, replicated_bytes=replicated_bytes,
            fits=fits,
        )
    return MeshDecomposition(
        np=lp.np_raw, budget_bytes=lp.budget_bytes,
        granule_bytes=lp.granule_bytes,
        sharded_bytes=sharded_bytes, replicated_bytes=replicated_bytes,
        fits=lp.fits,
    )


# ---------------------------------------------------------------------------
# Rule construction
# ---------------------------------------------------------------------------


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def default_rules(
    mesh,
    *,
    state_bytes: int = 0,
    act_bytes: int = 0,
    hierarchy: Optional[MemoryLevel] = None,
    seq_sharded: bool = False,
    overhead: float = 1.0,
    plan: Optional[HierarchicalPlan] = None,
) -> ShardingRules:
    """Architecture-independent rules: TP over "model" for the structural
    axes, batch over the data axes, and the FSDP / replicated choice made
    by the hierarchical planner over ``state_bytes`` (0 bytes -> trivially
    fits -> replicated).  Pass ``plan`` to consume an existing plan; the
    plan and its raw/quantized FSDP degrees ride in ``meta`` either way."""
    sizes = _axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data = _data_axes(mesh)
    fsdp_capacity = max(1, prod(sizes[a] for a in data))
    if plan is None:
        plan = mesh_plan(
            mesh,
            state_bytes=state_bytes // max(1, model_n),
            act_bytes=act_bytes,
            hierarchy=hierarchy,
            max_np=fsdp_capacity,
            overhead=overhead,
        )
    dec = plan.level("NVLINK") or plan.leaf()
    dcn = plan.level("DCN")
    embed_rule: AxisRule = None
    if not dec.replicated and data:
        embed_rule = _entry(data)
    param_rules: Dict[str, AxisRule] = {
        "embed": embed_rule,
        "heads": "model",
        "mlp": "model",
        "mlp_expert": "model",
        "vocab": "model",
        "experts": None,
        "layers": None,
    }
    act_rules: Dict[str, AxisRule] = {
        "batch": _entry(data),
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "kv_seq": "model" if seq_sharded else None,
        "mlp": "model",
        "experts": None,
        "state_heads": "model",
        "state_inner": None,
        "vocab": "model",
        "layers": None,
    }
    return ShardingRules(param_rules, act_rules, meta={
        "mesh_np": dec.np_raw,
        "fsdp_degree": dec.np,
        "mesh_budget_bytes": dec.budget_bytes,
        "mesh_fits": dec.fits,
        "fsdp": not dec.replicated,
        "fsdp_capacity": fsdp_capacity,
        "dcn_np": dcn.np if dcn is not None else 1,
        "plan": plan,
    })


def arch_rules(
    cfg,
    mesh,
    seq_sharded: bool = False,
    hierarchy: Optional[MemoryLevel] = None,
    act_bytes: int = 0,
    state_bytes_per_param: int = TRAIN_STATE_BYTES_PER_PARAM,
    plan: Optional[HierarchicalPlan] = None,
) -> ShardingRules:
    """Rules for one architecture on one mesh: the structural TP choices
    from ``cfg``, the memory-driven FSDP degree from the planner run on
    this architecture's resident state with its ``cfg.overhead``.  Pass
    ``hierarchy`` to decompose against another machine (tests shrink the
    HBM to force the replicated -> FSDP flip), ``act_bytes`` to reserve
    per-card HBM for activations, ``state_bytes_per_param`` for other
    memory models, ``plan`` to consume an existing plan."""
    sizes = _axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    rules = default_rules(
        mesh,
        state_bytes=cfg.param_count() * state_bytes_per_param,
        act_bytes=act_bytes,
        hierarchy=hierarchy,
        seq_sharded=seq_sharded,
        overhead=cfg.overhead,
        plan=plan,
    )
    pr, ar = dict(rules.param_rules), dict(rules.act_rules)

    # Structural TP refinements: drop mesh axes the architecture cannot fill.
    if cfg.n_heads % model_n != 0:
        ar["heads"] = None
    if cfg.n_kv_heads % model_n != 0:
        ar["kv_heads"] = None
    if cfg.vocab_size % model_n != 0:
        pr["vocab"] = None
        ar["vocab"] = None
    if cfg.ssm is not None:
        n_state_heads = (cfg.ssm.expand * cfg.d_model) // max(1, cfg.ssm.head_dim)
        if n_state_heads % model_n != 0:
            ar["state_heads"] = None
    if cfg.xlstm is not None and cfg.n_heads % model_n != 0:
        # Too few xLSTM heads for the model axis: shard the per-head state
        # inner dim instead (mLSTM's dh, sLSTM's d/H) iff both divide it.
        from repro_torch.models.xlstm import _round128

        ar["state_heads"] = None
        dh = _round128(cfg.xlstm.mlstm_proj_factor * cfg.d_model) \
            // max(1, cfg.n_heads)
        dhs = cfg.d_model // max(1, cfg.n_heads)
        if dh % model_n == 0 and dhs % model_n == 0:
            ar["state_inner"] = "model"
    if cfg.moe is not None:
        # Expert parallelism when the expert count fills the model axis,
        # tensor-parallel experts otherwise.
        if cfg.moe.n_experts % model_n == 0 and model_n > 1:
            pr["experts"] = "model"
            pr["mlp_expert"] = None
            ar["experts"] = "model"
        else:
            pr["experts"] = None
            pr["mlp_expert"] = "model"
            ar["experts"] = None
    return ShardingRules(pr, ar, meta=rules.meta)


def with_collectives(rules: ShardingRules, mode: str,
                     axis: str = "model") -> ShardingRules:
    """Request ring/serpentine collectives for the TP projections.  The
    choice rides in ``rules.meta``, so model code run under
    ``use_mesh_rules(mesh, rules)`` sees it through ``active_overlap``;
    ``axis`` names the mesh axis the ring runs over."""
    if mode not in COLLECTIVES:
        raise ValueError(f"unknown collectives {mode!r}; one of {COLLECTIVES}")
    meta = dict(rules.meta)
    meta["collectives"] = mode
    meta["overlap_axis"] = axis
    return ShardingRules(dict(rules.param_rules), dict(rules.act_rules),
                         meta=meta)


def resolve_collectives(rules: ShardingRules, mode: str) -> ShardingRules:
    """Resolve a collectives request, "auto" included: "auto" takes the
    serpentine rings exactly when the mesh-level decomposer chose FSDP
    (every step re-gathers parameter shards, so hiding the transfers
    behind the ring products pays); "ring"/"serpentine" always apply;
    "gspmd" leaves DTensor's own collectives."""
    if mode == "auto":
        mode = "serpentine" if rules.meta.get("fsdp") else "gspmd"
    if mode != "gspmd":
        rules = with_collectives(rules, mode)
    return rules


def with_kv_sharding(rules: ShardingRules, kv_shard: int,
                     axis: str = "model") -> ShardingRules:
    """KV-cache sharding from the decode plan's mesh level: heads over
    ``axis`` when ``kv_shard > 1``, replicated otherwise, never the
    sequence; the pool's page dim ("kv_pages") stays unsharded."""
    ar = dict(rules.act_rules)
    ar["kv_heads"] = axis if kv_shard > 1 else None
    ar["kv_seq"] = None
    ar["kv_pages"] = None
    meta = dict(rules.meta)
    meta["kv_shard"] = int(kv_shard)
    return ShardingRules(dict(rules.param_rules), ar, meta=meta)


def with_batch_guard(rules: ShardingRules, mesh,
                     global_batch: int) -> ShardingRules:
    """Trim the batch rule to the mesh axes whose product divides the global
    batch (a batch that cannot split evenly replicates instead of erroring)."""
    sizes = _axis_sizes(mesh)
    kept: list = []
    n = 1
    for a in _rule_axes(rules.act_rules.get("batch")):
        size = sizes.get(a, 1)
        if size and global_batch % (n * size) == 0:
            kept.append(a)
            n *= size
    ar = dict(rules.act_rules)
    ar["batch"] = _entry(kept)
    return ShardingRules(dict(rules.param_rules), ar, meta=dict(rules.meta))


# ---------------------------------------------------------------------------
# Placements from rules
# ---------------------------------------------------------------------------


def _divisible_spec(spec: PartitionSpec, shape: Sequence[int],
                    sizes: Dict[str, int]) -> PartitionSpec:
    """Drop mesh axes from dims they do not divide evenly (a 2-head KV
    projection on a 4-way model axis stays unsharded)."""
    entries = []
    for i, entry in enumerate(spec):
        names = list(_rule_axes(entry))
        while names and shape[i] % prod(sizes.get(n, 1) for n in names) != 0:
            names.pop()
        entries.append(_entry(names))
    return P(*entries)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim of size > 1 named in the entry of tensor dim ``dim``,
    ``Replicate()`` on the others (a size-1 axis splits nothing, and
    DTensor's view rules refuse some reshapes of a dim "sharded" on one)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _rule_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(
                f"mesh axes {entry!r} on dim {dim} must follow the mesh's "
                f"order {names} (DTensor shards major to minor in it)")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def logical_sharding(
    mesh,
    rules: ShardingRules,
    axes: Sequence[Optional[str]],
    shape: Optional[Sequence[int]] = None,
    kind: str = "param",
) -> tuple:
    """DTensor placements for one tensor from its logical axes (with the
    per-tensor divisibility guard when ``shape`` is known)."""
    spec = rules.param_spec(axes) if kind == "param" else rules.act_spec(axes)
    if shape is not None:
        spec = _divisible_spec(spec, shape, _axis_sizes(mesh))
    return placements(mesh, spec)


def param_shardings(mesh, rules: ShardingRules, specs: PyTree) -> PyTree:
    """Placements tree matching a ``ParamSpec`` tree."""
    from repro_torch.models.params import spec_tree_map

    return spec_tree_map(
        lambda _, s: logical_sharding(mesh, rules, s.axes, s.shape, "param"),
        specs,
    )


# ---------------------------------------------------------------------------
# Active-rules context (constrain / active_rule inside model code)
# ---------------------------------------------------------------------------


_CTX = threading.local()
#: Contexts open in any thread.  At 0 (one device, serving) every check
#: returns at once, without the thread-local lookup.
_OPEN = 0
_OPEN_LOCK = threading.Lock()


def _active():
    if not _OPEN:
        return None
    stack = getattr(_CTX, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def use_mesh_rules(mesh, rules: ShardingRules):
    """Activate (mesh, rules) for ``constrain``/``active_rule`` in model
    code run under this context."""
    global _OPEN
    stack = getattr(_CTX, "stack", None)
    if stack is None:
        stack = _CTX.stack = []
    stack.append((mesh, rules))
    with _OPEN_LOCK:
        _OPEN += 1
    try:
        yield
    finally:
        stack.pop()
        with _OPEN_LOCK:
            _OPEN -= 1


def active_rule(logical_axis: str) -> AxisRule:
    """The mesh axes the active rules map ``logical_axis`` to (None outside
    any ``use_mesh_rules`` context or for unmapped axes)."""
    ctx = _active()
    if ctx is None:
        return None
    return ctx[1].act_rules.get(logical_axis)


def active_overlap():
    """The overlap-collectives request of the active rules: ``(mesh, axis,
    mode, batch_axes)`` when the rules carry a ``with_collectives`` request
    and the ring axis has size > 1; None under gspmd rules, outside any
    context, or on a degenerate axis.  ``batch_axes`` are the mesh axes the
    activations' batch dim shards over, which the rings keep sharded."""
    ctx = _active()
    if ctx is None:
        return None
    mesh, rules = ctx
    mode = rules.meta.get("collectives", "gspmd")
    if mode == "gspmd":
        return None
    axis = rules.meta.get("overlap_axis", "model")
    sizes = _axis_sizes(mesh)
    if sizes.get(axis, 1) <= 1:
        return None
    batch = tuple(a for a in _rule_axes(rules.act_rules.get("batch"))
                  if a != axis and sizes.get(a, 1) > 1)
    return mesh, axis, mode, batch


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placements its logical axes
    imply under the active rules; the identity outside a
    ``use_mesh_rules`` context or on a plain tensor (the one-device path
    runs the same model code unsharded)."""
    ctx = _active()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = _divisible_spec(rules.act_spec(axes), x.shape, _axis_sizes(mesh))
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(x: torch.Tensor, heads: int, head_dim: int,
                logical: str) -> torch.Tensor:
    """``x`` ``(B, S, heads * head_dim)`` -> ``(B, S, heads, head_dim)``,
    constrained to ``("batch", None, logical, None)``.  DTensor cannot view
    a sharded dim into a head count the mesh axis does not divide (2 KV
    heads on a 4-way model axis), so on a mesh the flat dim first takes the
    sharding the head dim will have."""
    b, s = x.shape[0], x.shape[1]
    ctx = _active()
    if ctx is None or not isinstance(x, DTensor):
        return x.reshape(b, s, heads, head_dim)
    axes = ("batch", None, logical, None)
    mesh, rules = ctx
    spec = _divisible_spec(rules.act_spec(axes), (b, s, heads, head_dim),
                           _axis_sizes(mesh))
    want = placements(mesh, P(*spec[:3]))
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return constrain(x.reshape(b, s, heads, head_dim), axes)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: the
    gradient ``to_local`` hands back becomes a DTensor with the forward's
    (contiguous) strides, so its local tensor must have them too."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over each ``(mesh, dim)`` of ``groups`` in turn
    (functional collectives: they trace under ``FakeTensorMode``)."""
    import torch.distributed._functional_collectives as funcol

    for group in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", group))
    return t


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the embedding lookup.  On a mesh it runs on the
    table's vocab shards: each rank looks up the ids its shard holds
    (zeros for the others; ids outside it read row 0 and send it a zero
    gradient) and one all-reduce of the rows over each mesh dim that
    shards the vocab gives every id its row (``sum_partials``: exact, as
    each row is added to zeros); the backward is the lookup's own, into
    the local shard, so no rank gathers the table or builds its (V, d)
    gradient, and a mesh of one rank computes what the meshless lookup
    computes, bit for bit.  The table's "embed" columns are
    gathered over the mesh dims that shard them (FSDP over data) and
    nowhere else, and a mesh dim that shards both the vocab and the ids
    gathers the vocab there.  The result takes the ids' placements (plus
    the row dim, unsharded); the table's gradient is a partial sum over
    the mesh dims that shard the ids.  DTensor's own ``index``/
    ``index_put`` rules are avoided: some torch versions fail in the
    backward of a sharded lookup.  Off a mesh, ``table[ids]``."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    mesh = table.device_mesh
    if isinstance(ids, DTensor):
        ids_pl = tuple(ids.placements)
        ids = ids.to_local()
    else:
        ids_pl = (Replicate(),) * mesh.ndim
    want, grad, groups = [], [], []
    for i, (p, q) in enumerate(zip(table.placements, ids_pl)):
        if isinstance(p, Shard) and p.dim == 0 and not isinstance(q, Shard):
            want.append(p)
            grad.append(p)
            groups.append((mesh, i))
        else:
            want.append(Replicate())
            grad.append(Partial() if isinstance(q, Shard) else Replicate())
    if tuple(table.placements) != tuple(want):
        table = table.redistribute(mesh, want)
    lo, _ = local_extent(table, 0)
    local = table.to_local(grad_placements=grad)
    ids = ids.long()
    own = (ids >= lo) & (ids < lo + local.shape[0])
    rows = torch.where(own[..., None], local[torch.where(own, ids - lo, 0)],
                       0)
    for group in groups:
        rows, = sum_partials(group, rows)
    shape = list(rows.shape)
    for i, p in enumerate(ids_pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    return from_local_like(rows, mesh, ids_pl, shape)


def local_extent(t: DTensor, dim: int) -> Tuple[int, int]:
    """``(offset, length)`` of this rank's shard of ``t`` along ``dim``
    in global coordinates: DTensor's chunking (``ceil(n / parts)`` rows a
    shard, the last ones short), mesh dim by mesh dim.  Host arithmetic
    on the mesh coordinate only, so it holds under ``FakeTensorMode``."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    off, size = 0, int(t.shape[dim])
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            parts = mesh.size(i)
            chunk = -(-size // parts)
            lo = min(coord[i] * chunk, size)
            hi = min(lo + chunk, size)
            off, size = off + lo, hi - lo
    return off, size


def write_slice(buf: torch.Tensor, src: torch.Tensor, dim: int,
                start: int) -> None:
    """``buf.narrow(dim, start, src.shape[dim]).copy_(src)``, in place.  On
    a mesh ``buf`` is a DTensor (or a view of one) and the write happens on
    its local shard: ``src`` takes ``buf``'s placements (replicated along
    ``dim``), and each rank copies the part of ``[start, start + n)`` its
    shard of ``dim`` holds -- DTensor's own sharded ``index_put`` and
    slice assignment are avoided."""
    n = src.shape[dim]
    if not isinstance(buf, DTensor):
        if isinstance(src, DTensor):
            src = src.full_tensor()
        buf.narrow(dim, start, n).copy_(src)
        return
    mesh = buf.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in buf.placements)
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(src.placements) != want:
        src = src.redistribute(mesh, want)
    lo, size = local_extent(buf, dim)
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        buf.to_local().narrow(dim, a - lo, b - a).copy_(
            src.to_local().narrow(dim, a - start, b - a))


def _row_list(rows) -> list:
    if isinstance(rows, torch.Tensor):
        return [int(r) for r in rows.reshape(-1).tolist()]
    if isinstance(rows, (list, tuple)):
        return [int(r) for r in rows]
    return [int(rows)]


def read_rows(buf: DTensor, dim: int, rows) -> DTensor:
    """The rows ``rows`` (an index or a list) of ``buf`` along ``dim``, as
    a DTensor whose ``dim`` is replicated and whose other dims keep
    ``buf``'s placements: each rank takes the rows its shard of ``dim``
    holds, zeros elsewhere, and one all-reduce of the rows alone (over the
    mesh dims that shard ``dim``) replicates them.  Exact: a row is summed
    with zeros.  An index gives the row without ``dim`` (``buf[:, i]``'s
    shape for ``dim`` 1); DTensor's own sharded indexing is avoided."""
    idx = _row_list(rows)
    mesh = buf.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in buf.placements)
    local = buf.to_local()
    lo, size = local_extent(buf, dim)
    shape = list(local.shape)
    shape[dim] = len(idx)
    out = local.new_zeros(shape)
    for j, r in enumerate(idx):
        if lo <= r < lo + size:
            out.select(dim, j).copy_(local.select(dim, r - lo))
    split = [i for i, p in enumerate(buf.placements)
             if isinstance(p, Shard) and p.dim == dim]
    gshape = list(buf.shape)
    gshape[dim] = len(idx)
    rep = from_local_like(
        out, mesh, tuple(Partial() if i in split else p
                         for i, p in enumerate(want)), gshape)
    if split:
        rep = rep.redistribute(mesh, want)
    if not isinstance(rows, (list, tuple, torch.Tensor)):
        rep = rep.select(dim, 0)
    return rep


def write_rows(buf: DTensor, dim: int, rows, value) -> None:
    """Write ``value`` into the rows ``rows`` of ``buf`` along ``dim``, in
    place, on the local shards: ``value`` (a tensor shaped as
    ``read_rows`` returns, plain or DTensor, or a scalar) takes ``buf``'s
    placements with ``dim`` replicated, and each rank writes the rows its
    shard of ``dim`` holds -- no sharded ``index_put`` and no slice
    assignment on a DTensor."""
    idx = _row_list(rows)
    local = buf.to_local()
    lo, size = local_extent(buf, dim)
    if isinstance(value, torch.Tensor):
        if not isinstance(rows, (list, tuple, torch.Tensor)):
            value = value.unsqueeze(dim)
        value = rows_like(buf, dim, value).to_local()
    for j, r in enumerate(idx):
        if lo <= r < lo + size:
            dst = local.select(dim, r - lo)
            if isinstance(value, torch.Tensor):
                dst.copy_(value.select(dim, j))
            else:
                dst.fill_(value)


def rows_like(buf: DTensor, dim: int, value: torch.Tensor) -> DTensor:
    """``value`` (rows of ``buf`` along ``dim``, a plain tensor the same on
    every rank or a DTensor) placed as ``read_rows`` returns rows:
    ``buf``'s placements with ``dim`` replicated.  A plain value is split
    where ``buf`` shards its other dims, locally, with no collective."""
    mesh = buf.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in buf.placements)
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    if tuple(value.placements) != want:
        value = value.redistribute(mesh, want)
    return value


def rows_heads_roles(t: DTensor, row: Optional[int],
                     head: Optional[int]) -> Tuple[Optional[str], ...]:
    """``local_rows_heads``' roles as ``t`` is placed: "row" on the mesh
    dims that shard its ``row`` dim, "head" on those that shard its
    ``head`` dim, None elsewhere."""
    return tuple("row" if isinstance(p, Shard) and p.dim == row
                 else "head" if isinstance(p, Shard) and p.dim == head
                 else None for p in t.placements)


def local_rows_heads(fn, args: Sequence,
                     outs: Sequence[Tuple[Optional[int], ...]],
                     roles: Sequence[Optional[str]], partial: bool = True):
    """``fn`` on the local shards of tensors that share a row dim and a
    head dim, whose work is independent along both (a recurrent scan over
    batch rows and state heads).  ``args`` holds ``(tensor, row_dim,
    head_dim)`` triples (``tensor`` a DTensor, or None; either dim None
    where the tensor has none); ``roles`` names, for each mesh dim,
    whether it splits the rows ("row"), the heads ("head") or neither
    (None).  Each argument is redistributed so that every "row" mesh dim
    shards its row dim and every "head" one its head dim, the rest
    replicated; ``fn`` gets the local tensors; each tensor it returns,
    whose ``(row_dim, head_dim)`` ``outs`` gives, comes back as a DTensor
    placed alike (replicated over the "head" mesh dims where its head dim
    is None).  An ``outs`` entry may add the head dim's global size, where
    it is not the arguments' (heads returned flattened with their width).
    Differentiable: an argument replicated over a mesh dim that splits
    the work gets a partial-sum gradient there -- or, with ``partial``
    False, a whole one, where ``fn``'s own backward has summed it (a cell
    that splits a contraction over the "head" dims, ``reduce_grads``)."""
    tensors = [a for a, _, _ in args if isinstance(a, DTensor)]
    mesh = tensors[0].device_mesh
    n_rows = n_heads = None
    locals_ = []
    for t, row, head in args:
        if t is None:
            locals_.append(None)
            continue
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if row is not None:
            n_rows = t.shape[row]
        if head is not None:
            n_heads = t.shape[head]
        want, grad = [], []
        for role in roles:
            d = row if role == "row" else head if role == "head" else None
            want.append(Shard(d) if d is not None else Replicate())
            grad.append(Partial() if d is None and role and (
                partial or role == "row") else want[-1])
        if tuple(t.placements) != tuple(want):
            t = t.redistribute(mesh, want)
        locals_.append(_ContiguousGrad.apply(
            t.to_local(grad_placements=grad)))
    result = fn(*locals_)
    single = isinstance(result, torch.Tensor)
    wrapped = []
    for y, (row, head, *size) in zip((result,) if single else result, outs):
        place = tuple(Shard(row) if role == "row" and row is not None
                      else Shard(head) if role == "head" and head is not None
                      else Replicate() for role in roles)
        shape = list(y.shape)
        if row is not None:
            shape[row] = n_rows
        if head is not None:
            shape[head] = size[0] if size else n_heads
        wrapped.append(from_local_like(y, mesh, place, shape))
    return wrapped[0] if single else tuple(wrapped)


def _packed_sum(ts, group) -> list:
    """The tensors ``ts`` summed over ``group`` by ONE all-reduce of
    their flattened concatenation."""
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in ts]), (group,))
    return [f.view(t.shape) for f, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


class _SumPartials(torch.autograd.Function):
    """Partial sums over ``group`` made whole: one all-reduce forward; the
    identity backward, as every rank then computes the same thing from
    the sums and hands back the same gradient (Megatron's "g")."""

    @staticmethod
    def forward(ctx, group, *ts):
        return tuple(_packed_sum(ts, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


class _ReduceGrads(torch.autograd.Function):
    """Whole tensors entering a computation split over ``group``: the
    identity forward; one all-reduce of their gradients backward, which
    each rank's split computation gives as a partial sum (Megatron's
    "f")."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        ctx.like = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
                 for g, (s, dt, dev) in zip(grads, ctx.like)]
        return (None,) + tuple(_packed_sum(grads, ctx.group))


def sum_partials(group, *ts) -> tuple:
    """``ts``, each a partial sum over the mesh dim ``group`` (``(mesh,
    dim)``), summed there; ``ts`` unchanged where ``group`` is None."""
    return ts if group is None else _SumPartials.apply(group, *ts)


def reduce_grads(group, *ts) -> tuple:
    """``ts`` (whole on every rank of ``group``) as they are, their
    gradients summed over ``group`` in the backward; ``ts`` unchanged
    where ``group`` is None."""
    return ts if group is None else _ReduceGrads.apply(group, *ts)


def like_heads_of(t: DTensor, pool: DTensor, head_dim: int,
                  pool_head_dim: int, row_dim: Optional[int] = 0
                  ) -> tuple:
    """Placements for ``t`` whose heads (``head_dim``) shard exactly as the
    pool's (``pool_head_dim``): ``Shard(head_dim)`` on the mesh dims that
    shard the pool's heads; elsewhere ``t``'s own shard of ``row_dim``
    (None: replicated rows), or ``Replicate()``."""
    out = []
    for p_pool, p_t in zip(pool.placements, t.placements):
        if isinstance(p_pool, Shard) and p_pool.dim == pool_head_dim:
            out.append(Shard(head_dim))
        elif row_dim is not None and isinstance(p_t, Shard) \
                and p_t.dim == row_dim:
            out.append(Shard(row_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def from_local_like(local: torch.Tensor, mesh, place: tuple,
                    shape: Sequence[int]) -> DTensor:
    """``local`` (this rank's shard, contiguous) as a DTensor of global
    ``shape`` with ``place``."""
    shape = torch.Size(shape)
    return DTensor.from_local(local.contiguous(), mesh, place,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))
