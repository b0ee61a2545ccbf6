"""The decode and tile walks of ``repro.core.plan`` against the H100's
hierarchy.

``plan_run`` walks a ``MemoryLevel`` tree outermost-in and runs the
paper's Algorithm-1 / §2.1.1 search once per level with that level's phi:

  ==========  =============  ========================================
  level       phi            what the search decides
  ==========  =============  ========================================
  DCN         ``phi_mesh``   a decode workload: how many whole serving
                             replicas the fleet stands up (``cluster``)
  NVLINK      ``phi_mesh``   KV head sharding (decode) or the FSDP
                             degree (training state, ``dist.sharding``)
                             over the host's cards against one card's HBM
  SMEM        ``phi_smem``   a matmul workload: the kernel's tile
              (tile)         (``core.autotile``), against one block's
                             shared memory and the REG level below
  SMEM        ``phi_page``   a decode workload: the KV page, one
              (page)         sequence's token range cut until a page
                             fits, double-buffered
  L3/L2/L1    ``phi_simple`` a ``domain`` workload (the paper's host
  (cache)     / ``phi_c``    run-time system, ``Decomposer``): np
                             partitions of the composite domain, each
                             within the cache's per-core share
  ==========  =============  ========================================

Levels are classified by name, as in the reference, but with the port's
own tables: the reference's tile level is ``VMEM`` and its page levels are
``("VMEM", "L2")``, and Hopper's L2 would fit a page of hundreds of
thousands of tokens.  On Hopper a kernel block stages its tiles in shared
memory, so ``SMEM`` is the tile level of a matmul workload and the page
level of a decode workload (as ``VMEM`` is both in the reference), and
``NVLINK`` the mesh level.  Both SMEM searches consult the port's tuning
artifact (``tune.cache``) with precedence analytic < tuned.  The page
level also records the prefix cache's budget (``prefix_budget()``), and a
plan round-trips through JSON (``to_json``/``from_json``) and prints as
one line a level (``describe``).  A ``domain`` workload makes every level
with a cache line a cache level, except the register file: the port's
register level is ``REG`` (``REGISTER_LEVEL_NAMES``), where the
reference excludes its ``VREG``, so a domain planned on
``h100_hierarchy`` gets no cache search at the registers.
``PlanPolicy.tcl`` restricts that search to one named level (other cache
levels pass through as containers), and the cache path needs neither a
card spec nor the tuning artifact.  A decode workload at ``DCN`` places
whole replicas, as in the reference: the fleet's resident KV is
partitioned against one host's NVLINK domain, seeded by the requested
replica count (``PlanPolicy.n_workers``), so memory pressure can only raise
it; ``replicas()`` reads the realized count, and the walk below the DCN
level plans one replica as a single host.

On Hopper the planned page is the pool's allocation granule and the
prefill chunk, and nothing more: ``phi_page`` prices two buffered pages of
all KV heads, but the CUDA kernel (``csrc/paged_attention.cu``) stages
one KV head at a time, in f32, in fixed tiles of ``kTileTokens`` tokens,
without double buffering, so
its shared-memory use is set by the tile and ``G x D``, not by the page.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from repro_torch.core.autotile import MatmulTilePlan
from repro_torch.core.decompose import (
    NoValidDecomposition,
    PhiFn,
    _next_structurally_valid,
    find_optimal_np,
    make_phi_mesh,
    phi_simple,
    validate_np,
)
from repro_torch.core.distribution import (
    Array1DDistribution,
    Distribution,
    ReplicatedDistribution,
)
from repro_torch.core.hierarchy import MemoryLevel

__all__ = [
    "MESH_LEVEL_NAMES",
    "PAGE_ALIGN",
    "PAGE_BUFFERING",
    "PAGE_LEVEL_NAMES",
    "HierarchicalPlan",
    "LevelPlan",
    "PlanError",
    "PlanPolicy",
    "REGISTER_LEVEL_NAMES",
    "TILE_LEVEL_NAMES",
    "Workload",
    "leaf_matmul_plan",
    "plan_run",
    "quantize_divisor",
]


class PlanError(RuntimeError):
    """A structurally inadmissible plan for the caller's context.  Carries
    the offending level name and the full plan so callers can report or
    re-plan instead of string-matching a message."""

    def __init__(self, message: str, *, level: Optional[str] = None,
                 plan: Optional["HierarchicalPlan"] = None):
        super().__init__(message)
        self.level = level
        self.plan = plan


#: Interconnect levels: the level below holds the copies the search
#: partitions against (the cards' HBMs under NVLINK, the hosts' NVLINK
#: domains under DCN).
MESH_LEVEL_NAMES = ("DCN", "NVLINK")

#: The level a decode KV page is fit against: one block's shared memory.
PAGE_LEVEL_NAMES = ("SMEM",)

#: The level a matmul workload's kernel tile is fit against: the same.
TILE_LEVEL_NAMES = ("SMEM",)

#: The register file: it has an access granule but is no cache, so a
#: ``domain`` workload never searches it (the reference's ``VREG``).
REGISTER_LEVEL_NAMES = ("REG",)

#: Fallback sharding granule when no level below carries a line size.
DEFAULT_GRANULE = 128

#: Pages are whole groups of 8 tokens (the TPU's sublane group; on Hopper
#: it keeps every page a whole number of 16-byte vector loads per head).
PAGE_ALIGN = 8

#: Streaming pages are double-buffered: the next page's load overlaps the
#: current page's math, so two pages are resident at once.
PAGE_BUFFERING = 2


@dataclass(frozen=True)
class Workload:
    """What is decomposed: the decode (serving) workload, one matmul, or a
    paper-style composite domain.

    ``state_bytes`` is the shardable resident KV, ``replicated_bytes`` the
    per-card reserve (weights, activations).  ``matmul`` is the local
    ``C[m,n] = A[m,k] @ B[k,n]`` the SMEM level tiles.  ``domain`` is a
    composite of ``Distribution``s for the host's cache levels.
    ``kv_bytes_per_token`` is the global per-token KV footprint (bytes x
    heads x layers), ``kv_layers`` and ``kv_heads`` its layer count and
    shardable head extent, ``max_tokens`` one sequence's resident-token
    bound.
    """

    state_bytes: int = 0
    replicated_bytes: int = 0
    matmul: Optional[Tuple[int, int, int]] = None
    dtype_bytes: int = 2
    overhead: float = 1.0
    domain: Optional[Tuple[Distribution, ...]] = None
    kv_bytes_per_token: int = 0
    kv_layers: int = 1
    kv_heads: int = 0
    max_tokens: int = 0


@dataclass(frozen=True)
class PlanPolicy:
    """How to search: ``n_workers`` seeds the outermost level,
    ``quantize`` snaps mesh-level counts to realizable divisors,
    ``max_np`` caps a mesh level's partition count by name (e.g. the
    FSDP capacity of the data axes at "NVLINK"), ``strategy`` is every
    search's (the paper's proposal or its horizontal baseline: np =
    nWorkers at the mesh and cache levels, one row slab a worker at the
    tile level), ``tcl`` restricts that search to
    one named level, ``cache_phi`` is its footprint estimator, ``order``
    is the matmul traversal, ``spec`` the card whose granules align the
    tile (default: an H100 SXM), and ``use_tuned`` consults the port's
    tuning artifact (precedence analytic < tuned)."""

    n_workers: int = 1
    quantize: bool = True
    max_np: Mapping[str, int] = field(default_factory=dict)
    strategy: str = "cache_conscious"   # | "horizontal"
    tcl: Optional[str] = None
    cache_phi: PhiFn = phi_simple
    order: str = "cc"
    spec: Optional[Any] = None          # hw.h100.H100Spec
    use_tuned: bool = True


@dataclass(frozen=True)
class LevelPlan:
    """One level's share of the nested decomposition (as in the
    reference): ``np_raw`` is the Algorithm-1 result, ``np`` the realized
    count, ``detail`` a JSON-safe, kind-specific payload."""

    level: str
    kind: str            # mesh | tile | page | cache | container | leaf
    phi: str = ""
    budget_bytes: int = 0
    granule_bytes: int = 0
    n_workers: int = 1
    extent: int = 1
    np_raw: int = 1
    np: int = 1
    partition_bytes: float = 0.0
    fits: bool = True
    detail: Mapping[str, Any] = field(default_factory=dict)

    @property
    def replicated(self) -> bool:
        return self.np_raw <= 1


_LEVEL_FIELDS = ("level", "kind", "phi", "budget_bytes", "granule_bytes",
                 "n_workers", "extent", "np_raw", "np", "partition_bytes",
                 "fits")


@dataclass(frozen=True)
class HierarchicalPlan:
    """Serializable tree of per-level sub-plans (outermost level first)."""

    plan: LevelPlan
    child: Optional["HierarchicalPlan"] = None

    def nodes(self) -> Iterator["HierarchicalPlan"]:
        node: Optional[HierarchicalPlan] = self
        while node is not None:
            yield node
            node = node.child

    def levels(self) -> List[LevelPlan]:
        return [n.plan for n in self.nodes()]

    def level(self, name: str) -> Optional[LevelPlan]:
        for lp in self.levels():
            if lp.level == name:
                return lp
        return None

    def leaf(self) -> LevelPlan:
        return self.levels()[-1]

    def tile_plan(self) -> Optional[MatmulTilePlan]:
        """The SMEM level's ``MatmulTilePlan`` (None if no tile level)."""
        for lp in self.levels():
            if lp.kind == "tile":
                return MatmulTilePlan(**lp.detail["tile"])
        return None

    def page_plan(self) -> Optional[Mapping[str, Any]]:
        """The KV page record ``{"page_tokens", "page_bytes", "tok_bytes",
        "kv_shard", ...}`` (None if no page level)."""
        for lp in self.levels():
            if lp.kind == "page":
                return lp.detail["page"]
        return None

    def page_table(self) -> Optional[Mapping[str, Any]]:
        """The pool geometry ``{"pages_per_slot", "pages_total",
        "slots_bound", "prefix_budget_bytes"}`` (None if no page level):
        ``pages_total`` is how many logical pages the innermost mesh
        level's HBM leftover holds after the replicated reserve."""
        for lp in self.levels():
            if lp.kind == "page":
                return lp.detail.get("page_table")
        return None

    def prefix_budget(self) -> Optional[int]:
        """The mesh-level HBM leftover, in the scheduler's logical bytes
        (global per-token KV x tokens), that the cross-request prefix
        cache may keep resident (None if no page level; see
        ``serve/prefix.py``).  Recorded by the page level as
        ``detail["page_table"]["prefix_budget_bytes"]``.  ``from_dict``
        also reads plans the JAX package serialized (the same schema), and
        those written before the field existed fall back to the equivalent
        ``pages_total`` x global page bytes product."""
        ptab = self.page_table()
        if ptab is None:
            return None
        if "prefix_budget_bytes" in ptab:
            return int(ptab["prefix_budget_bytes"])
        page = self.page_plan() or {}
        global_page = (int(page.get("page_tokens", 0))
                       * int(page.get("tok_bytes", 0))
                       * int(page.get("layers", 1))
                       * int(page.get("kv_shard", 1)))
        return int(ptab.get("pages_total", 0)) * global_page

    def chunk_tokens(self) -> Optional[int]:
        """The prefill chunk length: the page level's ``page_tokens``."""
        page = self.page_plan()
        return int(page["page_tokens"]) if page else None

    def replicas(self) -> int:
        """The DCN level's realized partition count for a decode workload:
        the number of serving replicas the fleet stands up (1 when the
        plan has no DCN level).  ``repro_torch.cluster`` is the consumer:
        the DCN level places whole replicas (``detail["placement"] ==
        "replicas"``), so the cluster's width is the planner's outermost
        decision."""
        dcn = self.level("DCN")
        if dcn is None:
            return 1
        return int(dcn.detail.get("replicas", dcn.np))

    def kv_shard(self) -> int:
        """The KV head sharding degree the innermost mesh level chose."""
        shard = 1
        for lp in self.levels():
            if lp.kind == "mesh" and "kv_shard" in lp.detail:
                shard = int(lp.detail["kv_shard"])
        return shard

    # ------------------------------------------------------------------ JSON
    def to_dict(self) -> dict:
        d: Dict[str, Any] = {f: getattr(self.plan, f) for f in _LEVEL_FIELDS}
        d["detail"] = dict(self.plan.detail)
        d["child"] = self.child.to_dict() if self.child is not None else None
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "HierarchicalPlan":
        kw = {f: d[f] for f in _LEVEL_FIELDS}
        child = d.get("child")
        return cls(
            plan=LevelPlan(detail=dict(d.get("detail") or {}), **kw),
            child=cls.from_dict(child) if child else None,
        )

    @classmethod
    def from_json(cls, s: str) -> "HierarchicalPlan":
        return cls.from_dict(json.loads(s))

    def describe(self) -> List[str]:
        """One printable line per level, indented by depth (the reference's
        lines; the tile line names shared memory)."""
        lines = []
        for depth, lp in enumerate(self.levels()):
            ind = "  " * depth
            if lp.kind == "mesh":
                lines.append(
                    f"{ind}{lp.level}[mesh] np_raw={lp.np_raw} "
                    f"quantized={lp.np} extent={lp.extent} "
                    f"workers={lp.n_workers} budget={_fmt(lp.budget_bytes)} "
                    f"shard={_fmt(int(lp.detail.get('shard_bytes', 0)))} "
                    f"fits={lp.fits} phi={lp.phi}")
            elif lp.kind == "tile":
                t = lp.detail["tile"]
                lines.append(
                    f"{ind}{lp.level}[tile] block={t['bm']}x{t['bk']}x"
                    f"{t['bn']} np={lp.np} workers={lp.n_workers} "
                    f"smem={_fmt(t['est_vmem_bytes'])}/"
                    f"{_fmt(lp.budget_bytes)} order={t['order']} "
                    f"fits={lp.fits} phi={lp.phi} "
                    f"src={t.get('source', 'analytic')}")
            elif lp.kind == "page":
                pg = lp.detail["page"]
                lines.append(
                    f"{ind}{lp.level}[page] page_tokens={pg['page_tokens']} "
                    f"page={_fmt(pg['page_bytes'])} x{pg['buffering']} "
                    f"kv_shard={pg['kv_shard']} np={lp.np} "
                    f"budget={_fmt(lp.budget_bytes)} fits={lp.fits} "
                    f"phi={lp.phi} src={pg.get('source', 'analytic')}")
            elif lp.kind == "cache":
                lines.append(
                    f"{ind}{lp.level}[cache] np={lp.np} "
                    f"workers={lp.n_workers} budget={_fmt(lp.budget_bytes)} "
                    f"part={_fmt(int(lp.partition_bytes))} fits={lp.fits} "
                    f"phi={lp.phi}")
            elif lp.kind == "leaf":
                lines.append(
                    f"{ind}{lp.level}[leaf] granule={lp.granule_bytes}B "
                    f"size={_fmt(lp.budget_bytes)}")
            else:
                lines.append(
                    f"{ind}{lp.level}[container] size={_fmt(lp.budget_bytes)}")
        return lines


def _fmt(b: float) -> str:
    for unit, s in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if b >= s:
            return f"{b / s:.1f}{unit}"
    return f"{int(b)}B"


def quantize_divisor(np_raw: int, extent: int, multiple_of: int = 1) -> int:
    """Smallest divisor of ``extent`` >= ``np_raw`` (and a multiple of
    ``multiple_of``, the level above's partition count), falling back to
    ignoring that constraint when no such divisor exists."""
    np_raw = max(1, np_raw)
    if extent <= 0:
        return np_raw
    multiple_of = max(1, multiple_of)
    for d in range(1, extent + 1):
        if extent % d == 0 and d >= np_raw and d % multiple_of == 0:
            return d
    if multiple_of > 1:
        return quantize_divisor(np_raw, extent, 1)
    return extent


def _granule_below(level: MemoryLevel) -> int:
    for lvl in level.levels():
        if lvl.cache_line_size is not None:
            return lvl.cache_line_size
    return DEFAULT_GRANULE


def _classify(level: MemoryLevel, workload: Workload,
              policy: PlanPolicy) -> str:
    if level.name in MESH_LEVEL_NAMES and level.child is not None:
        return "mesh"
    if level.name in TILE_LEVEL_NAMES and workload.matmul is not None:
        return "tile"
    if (workload.kv_bytes_per_token > 0 and workload.matmul is None
            and workload.domain is None and level.name in PAGE_LEVEL_NAMES):
        return "page"
    if workload.domain is not None:
        if policy.tcl is not None:
            if level.name == policy.tcl:
                return "cache"
        elif (level.cache_line_size is not None
              and level.name not in REGISTER_LEVEL_NAMES):
            return "cache"
    if level.child is None:
        return "leaf"
    return "container"


def _record_level(level: MemoryLevel, kind: str, n_workers: int) -> LevelPlan:
    return LevelPlan(
        level=level.name or kind,
        kind=kind,
        budget_bytes=level.per_core_size(),
        granule_bytes=level.cache_line_size or 0,
        n_workers=n_workers,
        extent=max(1, len(level.siblings)),
    )


def _plan_mesh_level(level: MemoryLevel, workload: Workload,
                     policy: PlanPolicy, n_workers: int) -> LevelPlan:
    """Algorithm 1 with one child copy as the TCL (a card's HBM under
    NVLINK, a host's NVLINK domain under DCN)."""
    child = level.child
    budget = child.size
    granule = _granule_below(child)
    extent = max(1, len(child.siblings))
    cap = policy.max_np.get(level.name)
    if cap:
        extent = min(extent, max(1, cap))
    phi = make_phi_mesh(overhead=workload.overhead)
    if workload.kv_heads > 0 and level.name == "DCN":
        return _plan_replicas(level, workload, policy, n_workers, budget,
                              granule, extent, phi)
    dists: List[Distribution] = [
        Array1DDistribution(length=max(1, workload.state_bytes),
                            element_size=1)
    ]
    if workload.replicated_bytes:
        dists.append(ReplicatedDistribution(workload.replicated_bytes))
    if policy.strategy == "horizontal":
        np_raw = min(extent, max(1, n_workers))
        fits = validate_np(budget, granule, dists, np_raw, phi) == 1
    else:
        try:
            np_raw = find_optimal_np(budget, granule, dists, n_workers, phi,
                                     max_np=extent)
            fits = True
        except NoValidDecomposition:
            np_raw, fits = extent, False
    # A decode workload shards the KV cache over its heads: the only
    # degrees one axis realizes for a cache tensor are "unsharded" and "the
    # whole axis", and the heads must divide evenly.
    if workload.kv_heads > 0:
        head_extent = (extent if extent > 1
                       and workload.kv_heads % extent == 0 else 1)
        np_q = (head_extent if (np_raw > 1 and policy.quantize
                                and head_extent > 1)
                else (1 if policy.quantize else np_raw))
        if np_q < np_raw:
            fits = validate_np(budget, granule, dists, np_q, phi) == 1
    else:
        np_q = (quantize_divisor(np_raw, extent, multiple_of=n_workers)
                if policy.quantize else np_raw)
    part = sum(phi(granule, d, np_q) for d in dists)
    detail: Dict[str, Any] = {
        "tcl_level": child.name,
        "sharded_bytes": workload.state_bytes,
        "replicated_bytes": workload.replicated_bytes,
        "shard_bytes": -(-max(1, workload.state_bytes) // np_q),
        "overhead": workload.overhead,
    }
    if workload.kv_heads > 0:
        detail["kv_heads"] = workload.kv_heads
        detail["kv_shard"] = np_q
    return LevelPlan(
        level=level.name, kind="mesh", phi="phi_mesh",
        budget_bytes=budget, granule_bytes=granule,
        n_workers=max(1, n_workers), extent=extent,
        np_raw=np_raw, np=np_q, partition_bytes=part, fits=fits,
        detail=detail,
    )


def _plan_replicas(level: MemoryLevel, workload: Workload,
                   policy: PlanPolicy, n_workers: int, budget: int,
                   granule: int, extent: int, phi) -> LevelPlan:
    """A decode workload at the DCN level: the placement unit is a whole
    replica (request-level data parallelism), not a KV head slice.  Each
    host holds a full model copy and one share of the fleet's resident KV:
    ``state_bytes`` is one replica's, so the fleet's demand is ``state x
    extent``, partitioned against one host's NVLINK domain and seeded by
    the requested replica count (``n_workers``) -- memory pressure can
    only raise the count, never shrink it below the request."""
    fleet: List[Distribution] = [Array1DDistribution(
        length=max(1, workload.state_bytes) * extent, element_size=1)]
    if workload.replicated_bytes:
        fleet.append(ReplicatedDistribution(workload.replicated_bytes))
    try:
        np_raw = find_optimal_np(budget, granule, fleet, n_workers, phi,
                                 max_np=extent)
        fits = True
    except NoValidDecomposition:
        np_raw, fits = extent, False
    np_q = (quantize_divisor(np_raw, extent, multiple_of=n_workers)
            if policy.quantize else np_raw)
    part = sum(phi(granule, d, np_q) for d in fleet)
    return LevelPlan(
        level=level.name, kind="mesh", phi="phi_mesh",
        budget_bytes=budget, granule_bytes=granule,
        n_workers=max(1, n_workers), extent=extent,
        np_raw=np_raw, np=np_q, partition_bytes=part, fits=fits,
        detail={
            "tcl_level": level.child.name,
            "sharded_bytes": workload.state_bytes * extent,
            "replicated_bytes": workload.replicated_bytes,
            "shard_bytes": -(-max(1, workload.state_bytes) * extent
                             // np_q),
            "overhead": workload.overhead,
            "placement": "replicas",
            "replicas": np_q,
        },
    )


def _plan_tile_level(level: MemoryLevel, workload: Workload,
                     policy: PlanPolicy, n_workers: int) -> LevelPlan:
    """The card-level tile search (``core.autotile``) as one plan level:
    the SMEM level's budget for the staged tiles, the REG level below it
    for the accumulator."""
    from repro_torch.core import autotile

    spec = policy.spec or _default_spec()
    m, k, n = workload.matmul
    budget = level.per_core_size()
    reg_budget = (level.child.per_core_size() if level.child is not None
                  else spec.regs_per_sm * 4)
    tuning = None
    if policy.strategy == "horizontal":
        tile = autotile.plan_matmul_horizontal(
            m, k, n, dtype_bytes=workload.dtype_bytes, n_workers=n_workers)
    else:
        tile = autotile._search_matmul_tiles(
            m, k, n, workload.dtype_bytes, spec, policy.order, n_workers,
            budget, reg_budget)
        if policy.use_tuned:
            tile, tuning = autotile.apply_tuned_matmul(
                tile, workload.dtype_bytes, spec, budget, reg_budget)
    detail: Dict[str, Any] = {"tile": {f: getattr(tile, f) for f in (
        "m", "k", "n", "bm", "bk", "bn", "order", "np",
        "est_vmem_bytes", "strategy", "source")}}
    if tuning is not None:
        detail["tuning"] = tuning
    return LevelPlan(
        level=level.name, kind="tile", phi="phi_smem",
        budget_bytes=budget,
        granule_bytes=level.cache_line_size or DEFAULT_GRANULE,
        n_workers=max(1, n_workers), extent=max(1, tile.n_tasks),
        np_raw=tile.np, np=tile.np,
        partition_bytes=float(tile.est_vmem_bytes),
        fits=tile.est_vmem_bytes <= budget,
        detail=detail,
    )


def _default_spec():
    from repro_torch.hw.h100 import h100_spec

    return h100_spec()


def _plan_page_level(level: MemoryLevel, workload: Workload,
                     policy: PlanPolicy, n_workers: int, kv_shard: int = 1,
                     mesh_budget_bytes: int = 0) -> LevelPlan:
    """The decode KV page search: Algorithm 1 over one sequence's resident
    token range, one layer's KV slice (after head sharding) per token,
    until one partition -- a page, aligned and double-buffered -- fits the
    level.  The smallest np that fits gives the largest page."""
    budget = level.per_core_size()
    granule = level.cache_line_size or DEFAULT_GRANULE
    layers = max(1, workload.kv_layers)
    tok_bytes = max(1, -(-workload.kv_bytes_per_token
                         // (layers * max(1, kv_shard))))
    tokens = max(PAGE_ALIGN, workload.max_tokens)
    dist = Array1DDistribution(length=tokens, element_size=tok_bytes)

    def phi_page(_line: int, d: Distribution, np_: int) -> float:
        toks = -(-math.ceil(d.get_average_partition_size(np_))
                 // PAGE_ALIGN) * PAGE_ALIGN
        return float(PAGE_BUFFERING * toks * d.get_element_size())

    try:
        np_raw = find_optimal_np(budget, granule, [dist], 1,
                                 phi_page, max_np=tokens)
        fits = True
    except NoValidDecomposition:
        np_raw, fits = -(-tokens // PAGE_ALIGN), False
    per_partition = -(-tokens // np_raw)
    page_tokens = -(-per_partition // PAGE_ALIGN) * PAGE_ALIGN
    source = "analytic"
    tuning = None
    if policy.use_tuned and fits:
        tuned_pt, tuning = _tuned_page_tokens(policy, tok_bytes, tokens,
                                              budget)
        if tuned_pt is not None:
            page_tokens, source = tuned_pt, "tuned"
    page_bytes = page_tokens * tok_bytes
    n_pages = -(-tokens // page_tokens)
    # One logical page costs ``page_tokens x kv_bytes_per_token`` global
    # bytes; the innermost mesh level's HBM left after the replicated
    # reserve holds ``free x kv_shard`` logical bytes.
    global_page_bytes = page_tokens * max(1, workload.kv_bytes_per_token)
    per_card_free = max(0, mesh_budget_bytes - workload.replicated_bytes)
    pages_total = (per_card_free * max(1, kv_shard)) // global_page_bytes \
        if mesh_budget_bytes else 0
    return LevelPlan(
        level=level.name, kind="page", phi="phi_page",
        budget_bytes=budget, granule_bytes=granule,
        n_workers=max(1, n_workers), extent=n_pages,
        np_raw=np_raw, np=n_pages,
        partition_bytes=float(PAGE_BUFFERING * page_bytes), fits=fits,
        detail={"page": {
            "page_tokens": page_tokens,
            "page_bytes": page_bytes,
            "tok_bytes": tok_bytes,
            "tokens": tokens,
            "layers": layers,
            "kv_shard": max(1, kv_shard),
            "align": PAGE_ALIGN,
            "buffering": PAGE_BUFFERING,
            "source": source,
        }, "page_table": {
            "pages_per_slot": n_pages,
            "pages_total": int(pages_total),
            "slots_bound": int(pages_total // n_pages) if pages_total else 0,
            # The mesh-level HBM leftover in logical bytes (global token
            # bytes, like the scheduler's budget): what the prefix cache
            # (serve/prefix.py) may keep resident across requests.
            "prefix_budget_bytes": int(
                per_card_free * max(1, kv_shard)) if mesh_budget_bytes
            else 0,
        }, **({"tuning": tuning} if tuning is not None else {})},
    )


def _tuned_page_tokens(policy: PlanPolicy, tok_bytes: int, tokens: int,
                       budget: int) -> Tuple[Optional[int], Optional[dict]]:
    """A measured ``page_tokens`` winner for this decode shape, re-checked
    against the page level's own invariants (multiple of ``PAGE_ALIGN``,
    two buffered pages within the level); ``(None, None)`` leaves the
    analytic page standing."""
    from repro_torch.core.autotile import _tuning_detail
    from repro_torch.tune.cache import bucket_paged, lookup_tuned

    spec = policy.spec or _default_spec()
    entry = lookup_tuned("paged_attention", spec.name,
                         bucket_paged(tok_bytes, tokens))
    if entry is None:
        return None, None
    pt = entry.get("block", {}).get("page_tokens")
    if not (isinstance(pt, int) and pt >= PAGE_ALIGN
            and pt % PAGE_ALIGN == 0):
        return None, None
    pt = min(pt, -(-tokens // PAGE_ALIGN) * PAGE_ALIGN)
    if PAGE_BUFFERING * pt * tok_bytes > budget:
        return None, None
    return pt, _tuning_detail(entry)


def _plan_cache_level(level: MemoryLevel, workload: Workload,
                      policy: PlanPolicy, n_workers: int) -> LevelPlan:
    """The paper's host-cache search (``Decomposer``) as one plan level:
    Algorithm 1 over the composite domain against the cache's per-core
    share, or, horizontally, the first admissible np >= nWorkers."""
    dists = list(workload.domain)
    budget = level.per_core_size()
    line = level.cache_line_size or 64
    phi = policy.cache_phi
    if policy.strategy == "horizontal":
        np_raw = _next_structurally_valid(dists, max(1, n_workers), 1 << 30)
        if np_raw is None:
            raise NoValidDecomposition("horizontal: nWorkers not admissible")
        fits = validate_np(budget, line, dists, np_raw, phi) == 1
    else:
        np_raw = find_optimal_np(budget, line, dists, n_workers, phi)
        fits = True
    part = sum(phi(line, d, np_raw) for d in dists)
    return LevelPlan(
        level=level.name, kind="cache",
        phi=getattr(phi, "__name__", "phi"),
        budget_bytes=budget, granule_bytes=line,
        n_workers=max(1, n_workers), extent=0,
        np_raw=np_raw, np=np_raw, partition_bytes=part, fits=fits,
    )


def plan_run(hierarchy: MemoryLevel, workload: Workload,
             policy: PlanPolicy = PlanPolicy()) -> HierarchicalPlan:
    """Decompose ``workload`` against the whole ``hierarchy``.

    At the mesh level the search partitions state against one child copy,
    and that child level (HBM under NVLINK) is consumed by the search, so
    ``NVLINK -> HBM -> L2 -> SMEM -> REG`` plans as NVLINK[mesh] ->
    L2[container] -> SMEM[page] -> REG[leaf].  Each level's realized ``np``
    threads down as the next level's worker count, except a DCN level's
    replica count: each replica re-runs the walk below as one host.  A
    ``domain`` workload
    on a host tree plans RAM[container] -> L3/L2/L1[cache] (or, with
    ``tcl``, only that level as a cache).
    """
    nodes: List[LevelPlan] = []
    np_thread = max(1, policy.n_workers)
    kv_shard = 1
    mesh_budget = 0
    level: Optional[MemoryLevel] = hierarchy
    while level is not None:
        kind = _classify(level, workload, policy)
        if kind == "mesh":
            node = _plan_mesh_level(level, workload, policy, np_thread)
            nodes.append(node)
            np_thread = node.np
            if node.detail.get("placement") == "replicas":
                # Replica placement partitions requests across the fleet,
                # not one request's state: the fleet width does not thread
                # down as the next level's worker count.
                np_thread = 1
            if "kv_shard" in node.detail:
                kv_shard = int(node.detail["kv_shard"])
            mesh_budget = node.budget_bytes      # innermost mesh level wins
            nxt = level.child
            if nxt is not None and nxt.name not in MESH_LEVEL_NAMES:
                copies = max(1, len(nxt.siblings))   # the consumed TCL level
                np_thread = max(1, -(-np_thread // copies))
                nxt = nxt.child
            level = nxt
            continue
        if kind == "tile":
            node = _plan_tile_level(level, workload, policy, np_thread)
            nodes.append(node)
            np_thread = node.np
        elif kind == "page":
            node = _plan_page_level(level, workload, policy, np_thread,
                                    kv_shard, mesh_budget_bytes=mesh_budget)
            nodes.append(node)
            np_thread = node.np_raw
        elif kind == "cache":
            node = _plan_cache_level(level, workload, policy, np_thread)
            nodes.append(node)
            np_thread = node.np
        else:
            nodes.append(_record_level(level, kind, np_thread))
        level = level.child

    hp: Optional[HierarchicalPlan] = None
    for node in reversed(nodes):
        hp = HierarchicalPlan(plan=node, child=hp)
    return hp


@lru_cache(maxsize=512)
def leaf_matmul_plan(m: int, k: int, n: int, dtype_bytes: int = 2,
                     order: str = "cc", n_workers: int = 1
                     ) -> MatmulTilePlan:
    """Memoized SMEM-level tile plan for a local ``(m, k) @ (k, n)``: one
    single-card ``plan_run`` per (shape, dtype), which ``kernels.matmul_cc``
    pulls its plan from when the caller gives none."""
    spec = _default_spec()
    hp = plan_run(spec.hierarchy(),
                  Workload(matmul=(m, k, n), dtype_bytes=dtype_bytes),
                  PlanPolicy(order=order, n_workers=n_workers, spec=spec))
    return hp.tile_plan()
