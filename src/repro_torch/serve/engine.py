"""``ServeEngine`` -- the plan-driven serving engine (the port of
``repro.serve.engine`` for one card).

``ServeEngine(cfg, policy).generate(prompts)``; every batch and page
choice falls out of the plan:

  * ``plan_decode`` builds the decode workload (per-token KV bytes x heads
    x layers, ``core.plan.Workload``) and walks the card's hierarchy once:
    the NVLINK level chooses the KV head sharding (``kv_shard``), the SMEM
    level the page size (``page_tokens``) and the pool bound.
  * ``serve.kvcache.PageSpec`` turns the page into the allocation granule.

Two batching engines share the plan (``ServePolicy.batching``):

  * ``"paged"``: a fixed batch of decode slots over one global page pool
    (``serve.pages``), per-slot page tables, a finished slot backfilled by
    a new request mid-flight.  Prefill is CHUNKED: a prompt is cut into
    page-sized chunks written straight into the slot's pool pages and
    interleaved with decode ticks (``prefill="monolithic"`` runs one
    whole-prompt chunk instead).  ``prefix_cache="radix"`` keeps finished
    prompt pages (and, for recurrent families, page-boundary state
    snapshots on the card) in a refcounted radix tree (``serve.prefix``)
    that persists across ``generate`` calls, so a request sharing a cached
    prefix prefills only its suffix; ``export_pages``/``import_pages``
    move cached pages between engines.  A sliding-window family (Mixtral) frees
    the pages wholly below ``pos - window``; a token-free family (xLSTM)
    holds no pages and chunks its prompts at
    ``kvcache.DEFAULT_PAGE_TOKENS``.  An enc-dec request (Whisper) has its
    encoder run once at admission and its cross K/V installed into the
    slot's state rows, zero-padded to the trace's longest encoder.
  * ``"cohort"``: the batch unit is a *cohort* of same-shape prompts
    (``serve.scheduler``), prefilled together into a contiguous cache
    (``Model.init_cache``) and decoded one step per cohort per engine
    tick at the cohort's one position.  A growable cache grows one page at
    a time (``kvcache.grow_cache``), finished slots are compacted away at
    growth boundaries (``take_slots``), and when the budget cannot hold a
    growth the youngest other cohort is evicted and recomputed later.  A
    sliding-window cache is a ring of the window-clamped capacity,
    allocated and billed whole at admission.
  * ``"auto"``: paged where the plan has a page level and the family a
    paged path, else cohort.  ``"paged"`` for a family without a paged
    path (``vlm``) falls back to cohort, as in the reference.

Prompts are token-id sequences, or dicts: an enc-dec request ``{"enc_embeds":
(Se, d) frames, "tokens": decoder prompt}``, a vlm request ``{"embeds": (S,
d) patch and text embeddings, "positions_3d": (3, S) M-RoPE positions}``
(or ``{"tokens": ...}``; the positions then default to ``arange`` on all
three streams).  ``generate(on_token=)`` streams each token as it is
sampled (both engines).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import HierarchicalPlan, PlanError, PlanPolicy, \
    Workload, plan_run
from repro_torch.models.model import FAMILIES, Model
from repro_torch.obs import MetricsView, Registry, RingLog, Tracer
from repro_torch.serve.kvcache import (
    PageSpec,
    align_capacity,
    cache_capacity,
    grow_cache,
    kv_token_bytes,
    page_spec_from_plan,
    request_state_bytes,
    take_slots,
)
from repro_torch.serve.pages import (
    PAGED_FAMILIES,
    STATE_GROUPS,
    PagePool,
    PagedScheduler,
    copy_page,
    export_pool_pages,
    host_array,
    init_paged_cache,
    install_pool_pages,
    place_slot_rows,
    reset_slot,
    set_slot_rows,
    slot_rows,
)
from repro_torch.serve.prefix import (
    PREFIX_FAMILIES,
    STATE_FAMILIES,
    PrefixHit,
    RadixPrefixCache,
    _state_nbytes,
)
from repro_torch.serve.sampling import SamplingConfig, make_generator, sample
from repro_torch.serve.scheduler import Request, ServeScheduler
from repro_torch.serve.steps import ServeSteps, make_paged_steps, \
    make_serve_steps

PyTree = Any


# ---------------------------------------------------------------------------
# The decode plan
# ---------------------------------------------------------------------------


def _mesh_extents(mesh) -> Tuple[int, int]:
    """``(model_n, data_n)`` of a mesh (anything with ``mesh_dim_names``
    and ``shape``): the "model" extent and the product of the others;
    ``(1, 1)`` without one."""
    if mesh is None:
        return 1, 1
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    model_n = max(1, sizes.get("model", 1))
    total = 1
    for v in sizes.values():
        total *= v
    return model_n, max(1, total // model_n)


def plan_decode(
    cfg: ModelConfig,
    mesh=None,
    *,
    max_len: int = 4096,
    batch: int = 1,
    dtype_bytes: int = 2,
    spec=None,
    hierarchy=None,
    cluster: Optional[int] = None,
) -> HierarchicalPlan:
    """``plan_run`` over the decode workload: the serving counterpart of
    ``dist.sharding.mesh_plan``.

    ``mesh`` is anything with ``mesh_dim_names`` and ``shape`` (a
    ``DeviceMesh`` or ``dist.sharding.AbstractMesh``); None is one card.
    The hierarchy's NVLINK level spans the tensor-parallel ("model") axis
    -- the axis KV heads can shard over; the KV cache's batch dim already
    shards over the data axes, so the shardable state is one data shard's
    resident KV (``batch`` sequences of ``max_len`` tokens over
    ``data_n``), and the weight shard (over ``model_n``), the per-slot
    activation stream and any per-request state (over ``data_n``) ride
    along as the replicated reserve.  The hierarchy is ``hierarchy``, else
    ``spec.hierarchy(mesh_devices=model_n, hosts=cluster or 1)`` (default
    spec: an H100 SXM).

    ``cluster=N`` plans a multi-replica fleet: the hierarchy grows a DCN
    level over N hosts and the requested replica count seeds the
    outermost search, so the DCN level's realized ``np`` (``replicas()``)
    is the fleet width ``repro_torch.cluster`` stands up -- memory pressure
    can raise it, never shrink it; the subtree below it is one replica's
    plan, the single engine's.  Without ``cluster``, a plan with a DCN
    level raises ``PlanError`` (``level="DCN"``): one ``ServeEngine``
    cannot realize multi-host placement.
    """
    model_n, data_n = _mesh_extents(mesh)
    tok_bytes, layers, heads = kv_token_bytes(cfg, dtype_bytes)
    kv_state = (tok_bytes * max_len * batch) // data_n
    weights = cfg.param_count() * dtype_bytes // model_n
    stream = batch * cfg.d_model * dtype_bytes * 4
    fixed = batch * request_state_bytes(cfg, enc_len=max_len,
                                        dtype_bytes=dtype_bytes) // data_n
    if hierarchy is None:
        if spec is None:
            from repro_torch.hw.h100 import h100_spec
            spec = h100_spec()
        hierarchy = spec.hierarchy(mesh_devices=model_n,
                                   hosts=max(1, cluster or 1))
    plan = plan_run(
        hierarchy,
        Workload(
            state_bytes=max(1, kv_state),
            replicated_bytes=weights + stream + fixed,
            overhead=cfg.overhead,
            dtype_bytes=dtype_bytes,
            kv_bytes_per_token=tok_bytes,
            kv_layers=max(1, layers),
            kv_heads=heads,
            max_tokens=max_len,
        ),
        PlanPolicy(n_workers=max(1, cluster or 1), spec=spec),
    )
    if cluster is None and plan.level("DCN") is not None:
        raise PlanError(
            "decode plan contains a DCN level but no cluster was "
            "requested: a single ServeEngine cannot realize multi-host "
            "placement -- pass cluster=N and serve it with "
            "repro_torch.cluster, or plan against a single-host hierarchy",
            level="DCN", plan=plan)
    return plan


def kv_budget(plan: HierarchicalPlan, cfg: ModelConfig, dtype_bytes: int,
              kv_fraction: float = 0.8, mesh=None) -> int:
    """An engine's planned KV budget in the scheduler's logical bytes
    (tokens x the global per-token KV), and at least one page.

    Without a mesh: ``kv_fraction`` of the card's HBM left after one copy
    of the weights (the NVLINK level's budget is one card's HBM).  On a
    mesh the fleet's HBM is the NVLINK level's per-card budget times the
    cards; the weights are TP-sharded over "model" and replicated over the
    data axes, so one copy a data shard is reserved first; the cache
    shards over the data axes but replicates over "model" wherever the
    plan left its heads unsharded, so one logical byte costs ``model_n /
    kv_shard`` physical bytes and the headroom is divided by that."""
    ici = plan.level("NVLINK")
    per_card = ici.budget_bytes if ici is not None \
        else plan.leaf().budget_bytes
    model_n, data_n = _mesh_extents(mesh)
    hbm_total = per_card * model_n * data_n
    weights = cfg.param_count() * dtype_bytes * data_n
    replication = max(1, model_n // max(1, plan.kv_shard()))
    budget = int(kv_fraction * max(0, hbm_total - weights) / replication)
    return max(page_spec_from_plan(plan, cfg, dtype_bytes).page_bytes,
               budget)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServePolicy:
    """Engine knobs; everything memory-shaped defaults from the plan.

    ``batching``: "paged", the global page pool with per-slot continuous
    batching (a family without a paged path -- vlm -- falls back to
    cohort); "cohort", position-homogeneous cohorts over contiguous
    caches; or "auto", paged exactly when the plan has a page level and
    the family a paged path.  (The reference defaults to "cohort"; the
    port to "paged", its tuned engine -- greedy tokens are the same.)
    ``prefill``: "chunked" cuts prompts into planned-page-sized chunks
    interleaved with decode ticks; "monolithic" runs one whole-prompt
    chunk (identical tokens, no interleave); cohort batching ignores it.
    ``prefix_cache``: "radix" keeps finished prompt pages resident in a
    refcounted radix tree (budgeted by ``plan.prefix_budget()``) so a
    request sharing a cached prefix prefills only its unshared suffix;
    "off" disables it.  Families without exact cross-request KV reuse
    (enc-dec, vlm) and cohort batching ignore it.
    """

    max_new_tokens: int = 16
    max_slots: int = 8              # decode slots
    max_len: int = 4096             # per-sequence planning bound (tokens)
    kv_fraction: float = 0.8        # share of post-weights HBM given to KV
    kv_budget_bytes: Optional[int] = None   # override the planned budget
    batching: str = "paged"         # | "cohort" | "auto"
    prefill: str = "chunked"        # | "monolithic"
    prefix_cache: str = "off"       # | "radix"
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    def __post_init__(self):
        if self.batching not in ("cohort", "paged", "auto"):
            raise ValueError(f"unknown batching {self.batching!r}; "
                             f"one of ('cohort', 'paged', 'auto')")
        if self.prefill not in ("chunked", "monolithic"):
            raise ValueError(f"unknown prefill {self.prefill!r}; "
                             f"one of ('chunked', 'monolithic')")
        if self.prefix_cache not in ("off", "radix"):
            raise ValueError(f"unknown prefix_cache {self.prefix_cache!r}; "
                             f"one of ('off', 'radix')")


@dataclass
class _PagedSession:
    """Device state the paged engine keeps alive between ``generate``
    calls when the prefix cache is on: the pool's refcounts, the pooled
    cache buffers (they hold the cached prefixes' KV) and the radix tree.
    Rebuilt whenever the pool geometry changes (the cached pages would not
    survive a reshape)."""

    key: Any
    pool: PagePool
    cache: PyTree
    prefix: RadixPrefixCache


@dataclass
class _Run:
    """Engine-side state of one admitted cohort."""

    cid: int
    reqs: List[Request]
    steps: ServeSteps
    cache: PyTree
    next_tokens: torch.Tensor       # (B, 1) -- last sampled tokens
    capacity: Optional[int]         # growable token capacity (None: fixed)
    pos: int                        # tokens written so far per slot
    active: Dict[int, int]          # rid -> slot index, still decoding


class ServeEngine:
    """Plan-driven serving engine (see module docstring).

    ``device=None`` means ``"cuda"`` and raises where there is none;
    ``dtype`` (default float32) is the weights', pool's and compute dtype.
    ``params`` (the ``Model.param_specs`` tree of tensors) default to
    seeded random weights from ``seed``.  ``replica`` is this engine's id
    in a cluster: its tracer's ``pid``, so a merged cluster trace shows
    one process per replica.  ``hierarchy`` replaces the spec's for the
    decode plan.

    ``mesh`` (keyword-only: the port's callers pass ``policy`` second,
    where the reference's second positional is the mesh) serves over a
    ``DeviceMesh`` with axes ``("data", "model")``, from
    ``launch.mesh.make_host_mesh``: every rank runs the same engine on the
    same prompts.  The plan is made for the mesh (``plan_decode(cfg,
    mesh)``), the budget is the fleet's (``kv_budget(mesh=)``), the
    parameters are DTensors with the steps' placements, the pool's (or
    cohort cache's) KV heads shard over "model" exactly when the plan's
    ``kv_shard > 1``, and the host side -- scheduler, page pool, page
    table, sampling -- is the same on every rank, which samples the same
    tokens from the logits gathered whole.  ``mesh=None`` is the meshless
    engine, the reference's one-device host mesh.  On a mesh the engine
    serves what it serves without one (``MESH_FAMILIES``: every family
    cohort and every paged family paged, with the radix prefix cache and
    ``export_pages``/``import_pages``).  The per-slot state rows of the
    paged engine (slots over the data axes, heads over "model") are
    reset, saved, snapshotted and restored through each rank's own
    shard; mla_moe's latent pool (one KV head of ``R + dr``) replicates
    over "model" and its paged blocks run the kernel on each rank's
    query rows and heads; the persistent radix session keeps its cache
    placed, a CoW copy copies each rank's shard of the page, and exported
    pages are gathered whole (the meshless payload), installed pages
    split to each rank's shard.
    """

    #: Families each batching serves on a mesh: all of them.  The per-slot
    #: state rows (xLSTM and Mamba2 state, enc_dec's cross K/V) are read
    #: and written through each rank's local shard
    #: (``serve.pages.slot_rows``); hybrid_ssm's scan and step and the
    #: paged attention blocks (the K/V pools and MLA's latent pool) run on
    #: local shards.
    MESH_FAMILIES = {"paged": PAGED_FAMILIES, "cohort": FAMILIES}

    #: Ring-buffer bounds: the tracer's event ring, the interleave log and
    #: each request's token-time log cap here (overflow drops the oldest).
    TRACE_CAPACITY = 65536
    LOG_CAPACITY = 65536
    TOKEN_TIMES_CAPACITY = 8192

    def __init__(
        self,
        cfg: ModelConfig,
        policy: ServePolicy = ServePolicy(),
        dtype=None,
        params: Optional[PyTree] = None,
        seed: int = 0,
        spec=None,
        device=None,
        replica: int = 0,
        *,
        mesh=None,
        hierarchy=None,
    ):
        if mesh is not None:
            device = device if device is not None else mesh.device_type
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.policy = policy
        self.dtype = dtype if dtype is not None else torch.float32
        self._dtype_bytes = torch.tensor([], dtype=self.dtype).element_size()
        self.plan = plan_decode(
            cfg, mesh, max_len=policy.max_len, batch=policy.max_slots,
            dtype_bytes=self._dtype_bytes, spec=spec, hierarchy=hierarchy)
        self.page: PageSpec = page_spec_from_plan(self.plan, cfg,
                                                  self._dtype_bytes)
        self.batching = policy.batching
        if self.batching == "auto":
            # Paged exactly when the plan exposes a page level to size the
            # pool from and the family has a per-slot decode path.
            self.batching = ("paged" if self.plan.page_plan() is not None
                             and cfg.family in PAGED_FAMILIES else "cohort")
        elif self.batching == "paged" and cfg.family not in PAGED_FAMILIES:
            self.batching = "cohort"        # no paged decode path
        self.model = Model(cfg)
        self.budget_bytes = (int(policy.kv_budget_bytes)
                             if policy.kv_budget_bytes is not None
                             else kv_budget(self.plan, cfg,
                                            self._dtype_bytes,
                                            policy.kv_fraction, mesh=mesh))
        # Each engine builds only its own steps and bookkeeping: the paged
        # engine its pool steps, the cohort engine its scheduler (its
        # contiguous-cache steps are made per cohort, at its capacity).
        paged = self.batching == "paged"
        self._steps_cache: Dict[Any, Any] = {}
        self.steps = self._paged_steps(policy.max_slots) if paged else None
        self._param_sharding = None
        if mesh is None:
            self.params = (params if params is not None
                           else self.model.init(seed, self.device,
                                                self.dtype))
        else:
            # Placed as the widest paged steps (or a cohort of max_slots)
            # place them; steps that place them otherwise redistribute.
            ref = self.steps or self._steps(policy.max_slots, 1, 1)
            self._param_sharding = ref.param_sharding
            if params is not None:
                self.params = ref.place_params(params)
            else:
                from repro_torch.launch.trainer import distribute

                def place(path, leaf):
                    pl = ref.param_sharding
                    for k in path.split("."):
                        pl = pl[k]
                    return distribute(leaf, mesh, pl)

                self.params = self.model.init(seed, self.device, self.dtype,
                                              place=place)
        self.scheduler = None if paged else ServeScheduler(
            self.budget_bytes, self.page, max_slots=policy.max_slots)
        self._live_pool: Optional[PagePool] = None
        self._live_sched: Optional[PagedScheduler] = None
        self._paged_session: Optional[_PagedSession] = None
        self._stream_cb = None          # per-call on_token callback
        self._stream_ix: Dict[int, int] = {}    # rid -> index in this call
        self._next_rid = 0
        self._t_submit: Dict[int, float] = {}   # rid -> submit monotonic s
        # The metrics spine: one typed Registry and one Tracer per engine
        # (pid = replica id).  ``engine.metrics`` is a MetricsView over the
        # registry with the JAX engine's keys.
        self.replica = int(replica)
        self.obs = Registry()
        self.tracer = Tracer(capacity=self.TRACE_CAPACITY, pid=self.replica)
        o = self.obs
        for name in ("tokens", "tokens_recomputed", "decode_steps",
                     "cohorts", "evictions", "slot_steps",
                     "active_slot_steps", "backfills", "stalls",
                     "prefill_chunks", "prefill_tokens", "prefix_hits",
                     "prefix_misses", "prefix_hit_tokens", "pages_saved",
                     "cow_copies", "prefix_nodes_inserted",
                     "interleave_dropped", "token_times_dropped"):
            o.counter(name)
        o.set("page_tokens", self.page.page_tokens, unit="tokens")
        o.set("page_bytes", self.page.page_bytes, unit="B")
        o.set("budget_bytes", self.budget_bytes, unit="B")
        o.set("kv_shard", self.plan.kv_shard())
        o.histogram("ttft_s", unit="s")
        o.histogram("inter_token_s", unit="s")
        o.histogram("queue_wait_s", unit="s")
        self.metrics: MetricsView = MetricsView(o, objects={
            "batching": self.batching,
            "plan_page_table": dict(self.plan.page_table() or {}),
            "capacities": [],
            "prefix_cache": policy.prefix_cache,
        })

    # ------------------------------------------------------------------ steps
    def _paged_steps(self, n_slots: int):
        """The paged steps for a decode batch of ``n_slots``.  Off a mesh
        one set serves every slot count (``self.steps``); on a mesh the
        slots' data sharding depends on it, and the steps are kept, one
        set a slot count."""
        key = ("paged", n_slots)
        ss = self._steps_cache.get(key)
        if ss is None:
            ss = make_paged_steps(self.cfg, self.mesh, n_slots=n_slots,
                                  max_len=self.policy.max_len,
                                  dtype=self.dtype, decode_plan=self.plan)
            if self.mesh is not None:
                self._steps_cache[key] = ss
        return ss

    def _steps(self, n_slots: int, prompt_len: int, capacity: int
               ) -> ServeSteps:
        """The cohort steps for ``n_slots`` prompts of ``prompt_len`` tokens
        into a cache of ``capacity``: made afresh a cohort off a mesh; on
        a mesh kept, one set a shape (the reference's engine keeps its
        compiled steps so)."""
        key = (n_slots, prompt_len, capacity)
        ss = self._steps_cache.get(key)
        if ss is None:
            ss = make_serve_steps(
                self.cfg, ShapeConfig("serve", prompt_len, n_slots, "decode"),
                self.mesh, dtype=self.dtype,
                max_len_extra=capacity - prompt_len, decode_plan=self.plan)
            if self.mesh is not None:
                self._steps_cache[key] = ss
        return ss

    def _params_for(self, ss) -> PyTree:
        """The parameters placed as ``ss`` takes them (redistributed, and
        kept so, when its placements differ from the current ones)."""
        if self.mesh is not None and ss.param_sharding != \
                self._param_sharding:
            self.params = ss.place_params(self.params)
            self._param_sharding = ss.param_sharding
        return self.params

    def _regather(self, ss, fn, cache: PyTree) -> PyTree:
        """``fn(cache)`` on a cache gathered whole, placed again after (the
        cohort cache's growth and compaction change its shape; the
        identity of a gather off a mesh)."""
        if self.mesh is None:
            return fn(cache)
        from repro_torch.serve.steps import full_tensor
        from repro_torch.tree import tree_map

        return ss.place_cache(fn(tree_map(full_tensor, cache)))

    # -------------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, Any]:
        """One telemetry dict: pool, slots, tokens and the prefix tree
        (the live pool when one exists -- mid-generate, or a persistent
        radix session holding cached prefixes -- else the last run's
        geometry, else the plan's ``page_table``)."""
        ptab = dict(self.plan.page_table() or {})
        pages_total = int(self.metrics.get("pages_total")
                          or ptab.get("pages_total") or 0)
        free_pages, used_pages = pages_total, 0
        slots_total = int(self.policy.max_slots)
        slots_free = slots_total
        pool = self._live_pool
        if pool is not None:
            pages_total = pool.pages_total - 1      # minus the null page
            free_pages = int(self.obs.value("free_pages", pool.free_pages))
            used_pages = int(self.obs.value("used_pages", pool.used_pages))
        if self._live_sched is not None:
            slots_free = max(0, slots_total - len(self._live_sched.active()))
        out = {
            "batching": self.batching,
            "free_pages": int(free_pages),
            "used_pages": int(used_pages),
            "pages_total": int(pages_total),
            "slots_free": slots_free,
            "slots_total": slots_total,
            "page_tokens": self.page.page_tokens,
            "page_bytes": self.page.page_bytes,
            "kv_shard": self.plan.kv_shard(),
            "tokens": int(self.metrics.get("tokens", 0)),
            "decode_steps": int(self.metrics.get("decode_steps", 0)),
            "prefill_chunks": int(self.metrics.get("prefill_chunks", 0)),
            "prefix_nodes": 0,
            "prefix_pages": 0,
            "prefix_resident_bytes": 0,
            "prefix_state_bytes": 0,
            "prefix_state_budget_bytes": None,
        }
        sess = self._paged_session
        if sess is not None:
            out["prefix_nodes"] = sess.prefix.n_nodes
            out["prefix_pages"] = sess.prefix.n_pages
            out["prefix_resident_bytes"] = sess.prefix.resident_bytes
            out["prefix_state_bytes"] = sess.prefix.state_bytes
            out["prefix_state_budget_bytes"] = \
                sess.prefix.state_budget_bytes
        return out

    # -------------------------------------------------------- token streaming
    def _notify(self, rid: int, tok: Optional[int]) -> None:
        """Forward one delivered token (or a ``None`` stream reset after a
        recompute preemption: earlier tokens will re-emit) to the caller's
        ``on_token(index_in_call, token)`` callback."""
        cb = self._stream_cb
        if cb is None:
            return
        ix = self._stream_ix.get(rid)
        if ix is not None:
            cb(ix, tok)

    # --------------------------------------------------------------- requests
    @staticmethod
    def _normalize_prompt(prompt) -> Dict[str, np.ndarray]:
        """A prompt's features as host arrays: a dict prompt's entries
        (enc-dec: ``enc_embeds`` and ``tokens``; vlm: ``embeds`` and
        ``positions_3d``, or ``tokens``), else ``{"tokens": ...}`` of the
        token ids."""
        if isinstance(prompt, dict):
            return {k: np.asarray(v) for k, v in prompt.items()}
        return {"tokens": np.asarray(prompt, dtype=np.int32).reshape(-1)}

    def _make_request(self, prompt, max_new: int,
                      paged: bool = False) -> Request:
        feats = self._normalize_prompt(prompt)
        plen = int(feats["tokens"].shape[-1] if "tokens" in feats
                   else feats["embeds"].shape[0])
        enc_len = (int(feats["enc_embeds"].shape[0])
                   if "enc_embeds" in feats else 0)
        rid = self._next_rid
        self._next_rid += 1
        # Fixed-extent caches (sliding-window rings) allocate their whole
        # window-clamped capacity at admission and never grow, so the slot
        # is billed for all of it up front; growable caches pin only
        # prompt + the first decode page (the Request default).  The paged
        # pool has no rings, so admission there is always prompt + 1.
        admit_tokens = None
        if not paged and not self._growable() and self.cfg.sliding_window:
            admit_tokens = min(plen + max_new + 1, self.cfg.sliding_window)
        return Request(rid=rid, prompt_len=plen, max_new=max_new,
                       features=feats, group=(plen, enc_len),
                       state_bytes=request_state_bytes(
                           self.cfg, enc_len, self._dtype_bytes),
                       admit_tokens=admit_tokens)

    def _encode_req(self, req: Request):
        """Enc-dec admission: the encoder pass and the cross projections,
        once for this request (``(nd, 1, Se, KV, D)`` each).  None for
        every other family."""
        if self.steps.encode is None:
            return None
        enc = torch.from_numpy(np.asarray(req.features["enc_embeds"],
                                          dtype=np.float32))
        return self.steps.encode(self.params, enc[None].to(self.device))

    # --------------------------------------------------------------- generate
    def generate(
        self,
        prompts: Sequence[Any],
        max_new_tokens=None,
        sampling: Optional[SamplingConfig] = None,
        on_token=None,
    ) -> List[List[int]]:
        """Serve ``prompts`` (token-id sequences, or the family's dict
        prompts: see the module docstring), returning each request's
        generated token ids in submission order.  ``max_new_tokens`` is
        one int for all requests or a per-request sequence.

        ``on_token(i, tok)`` streams each delivered token as it is sampled
        (``i``: the request's index in this call); the tokens are host
        ints already, so streaming adds no wait on the card.  A recompute
        preemption invalidates a request's streamed tokens: the callback
        receives ``on_token(i, None)`` and the tokens re-emit from
        scratch."""
        scfg = sampling or self.policy.sampling
        max_new = (max_new_tokens if max_new_tokens is not None
                   else self.policy.max_new_tokens)
        if isinstance(max_new, int):
            max_new = [max_new] * len(prompts)
        if len(max_new) != len(prompts):
            raise ValueError(
                f"max_new_tokens: expected one int or {len(prompts)} "
                f"entries, got {len(max_new)}")
        if not prompts:
            return []
        self._stream_cb = on_token
        try:
            if self.batching == "paged":
                return self._generate_paged(prompts, max_new, scfg)
            return self._generate_cohort(prompts, max_new, scfg)
        finally:
            self._stream_cb = None
            self._stream_ix = {}

    def _finalize_utilization(self) -> None:
        steps = self.metrics["slot_steps"]
        self.metrics["slot_utilization"] = (
            self.metrics["active_slot_steps"] / steps if steps else 0.0)

    # ------------------------------------------------------ cohort batching
    def _growable(self) -> bool:
        """Whether the contiguous cache grows page by page: the family
        holds per-token KV and no sliding-window ring."""
        tok_bytes, _, _ = kv_token_bytes(self.cfg, self._dtype_bytes)
        return tok_bytes > 0 and not self.cfg.sliding_window

    def _stack_features(self, reqs: List[Request]) -> Dict[str, Any]:
        """The cohort's prompt batch on the card: each feature stacked on
        a new batch axis (axis 1 of ``positions_3d``, axis 0 of the rest).
        A vlm cohort without ``positions_3d`` gets ``arange`` on all three
        streams."""
        out = {}
        for k in reqs[0].features:
            arr = np.stack([r.features[k] for r in reqs],
                           axis=1 if k == "positions_3d" else 0)
            out[k] = torch.from_numpy(arr).to(self.device)
        if self.cfg.family == "vlm" and "positions_3d" not in out:
            s = reqs[0].prompt_len
            out["positions_3d"] = torch.arange(
                s, device=self.device).expand(3, len(reqs), s)
        return out

    def _prefill_cohort(self, cid: int, reqs: List[Request],
                        outputs: Dict[int, List[int]], scfg: SamplingConfig,
                        gen) -> _Run:
        prompt_len = reqs[0].prompt_len
        max_new = max(r.max_new for r in reqs)
        if self._growable():
            capacity = align_capacity(prompt_len + 1, self.page)
        else:
            capacity = prompt_len + max_new + 1
        ss = self._steps(len(reqs), prompt_len, capacity)
        batch = self._stack_features(reqs)
        for r in reqs:
            now = time.monotonic()
            t_sub = self._t_submit.get(r.rid, now)
            self.tracer.complete("queue_wait", t_sub, now, tid=r.rid + 1,
                                 args={"rid": r.rid, "cohort": cid})
            self.obs.observe("queue_wait_s", now - t_sub)
        tp0 = time.monotonic()
        logits, cache = ss.prefill(self._params_for(ss), batch)
        self.tracer.complete("prefill", tp0, time.monotonic(), tid=0,
                             args={"cohort": cid, "slots": len(reqs),
                                   "prompt": prompt_len})
        toks = sample(logits, scfg, gen)
        run = _Run(
            cid=cid, reqs=reqs, steps=ss, cache=cache,
            next_tokens=toks[:, None],
            capacity=(cache_capacity(self.cfg, cache)
                      if self._growable() else None),
            pos=prompt_len,
            active={r.rid: i for i, r in enumerate(reqs)})
        self.metrics["cohorts"] += 1
        if run.capacity is not None:
            self.metrics["capacities"].append(run.capacity)
        self._emit(run, toks, outputs, scfg)
        return run

    def _emit(self, run: _Run, toks: torch.Tensor,
              outputs: Dict[int, List[int]], scfg: SamplingConfig) -> None:
        """Deliver a step's tokens to the cohort's active slots; a slot
        whose request is done leaves ``run.active`` (it rides along in the
        batch until the next compaction)."""
        toks = toks.cpu().numpy().reshape(-1)
        for r in list(run.reqs):
            slot = run.active.get(r.rid)
            if slot is None:
                continue
            t = int(toks[slot])
            outputs[r.rid].append(t)
            now = time.monotonic()
            if len(outputs[r.rid]) == 1:
                self.tracer.instant("first_token", tid=r.rid + 1,
                                    args={"rid": r.rid})
                self.obs.observe(
                    "ttft_s", now - self._t_submit.get(r.rid, now))
            self._notify(r.rid, t)
            self.metrics["tokens"] += 1
            if len(outputs[r.rid]) >= r.max_new or \
                    (scfg.eos_id is not None and t == scfg.eos_id):
                del run.active[r.rid]
                self.scheduler.finish(run.cid, r.rid)
                self.tracer.complete(
                    "request", self._t_submit.get(r.rid, now), now,
                    tid=r.rid + 1,
                    args={"rid": r.rid, "tokens": len(outputs[r.rid])})

    def _compact(self, run: _Run) -> None:
        """Drop finished slots from the cohort batch: slice the cache (and
        the pending next-token column) down to the survivors so their
        pages release now instead of at whole-cohort retirement.  Called
        at growth boundaries, where the freed pages pay for the copy."""
        if not run.active or len(run.active) == len(run.reqs):
            return
        keep = [r for r in run.reqs if r.rid in run.active]
        idx = [run.active[r.rid] for r in keep]
        run.cache = self._regather(run.steps,
                                   lambda c: take_slots(c, idx), run.cache)
        run.next_tokens = run.next_tokens[idx]
        run.reqs = keep
        run.active = {r.rid: i for i, r in enumerate(keep)}
        self.scheduler.shrink_slots(run.cid, [r.rid for r in keep])

    def _ensure_capacity(self, run: _Run, runs: Dict[int, _Run],
                         outputs: Dict[int, List[int]]) -> None:
        """Room for the next token: a full growable cache first compacts,
        then reserves one more page a slot -- evicting the youngest other
        cohort (recompute preemption) while the budget refuses -- and is
        reallocated one page longer."""
        if run.capacity is None or run.pos + 1 <= run.capacity:
            return
        self._compact(run)
        needed = run.capacity + self.page.page_tokens
        while not self.scheduler.reserve(run.cid, needed):
            victim = self.scheduler.youngest_other(run.cid)
            if victim is None or victim not in runs:
                raise RuntimeError(
                    f"KV budget {self.scheduler.budget_bytes} cannot hold "
                    f"one growing cohort; raise kv_budget_bytes")
            for r in self.scheduler.evict(victim):
                self.obs.inc("tokens_recomputed", len(outputs[r.rid]))
                self.tracer.instant(
                    "preempt", tid=r.rid + 1,
                    args={"rid": r.rid, "cohort": victim,
                          "tokens_lost": len(outputs[r.rid])})
                outputs[r.rid] = []
                self._notify(r.rid, None)
            del runs[victim]
            self.metrics["evictions"] += 1
        run.cache = self._regather(
            run.steps, lambda c: grow_cache(self.cfg, c, needed), run.cache)
        run.capacity = needed
        self.metrics["capacities"].append(needed)

    def _decode_cohort(self, run: _Run, runs: Dict[int, _Run],
                       outputs: Dict[int, List[int]], scfg: SamplingConfig,
                       gen) -> None:
        self._ensure_capacity(run, runs, outputs)
        batch = {"tokens": run.next_tokens}
        if self.cfg.family == "vlm":
            # The reference's decode positions: all three streams at the
            # cache's position (the sequence length so far).
            batch["positions_3d"] = torch.full(
                (3, len(run.reqs), 1), int(run.cache["pos"]),
                dtype=torch.int64, device=self.device)
        td0 = time.monotonic()
        logits, run.cache = run.steps.decode(self._params_for(run.steps),
                                             run.cache, batch)
        toks = sample(logits, scfg, gen)
        self.tracer.complete("decode_tick", td0, time.monotonic(), tid=0,
                             args={"cohort": run.cid,
                                   "active": len(run.active)})
        run.next_tokens = toks[:, None]
        run.pos += 1
        self.metrics["decode_steps"] += 1
        # Utilization: this step decoded len(reqs) rows, of which only the
        # still-active ones deliver a token (finished slots ride along
        # until the next growth-boundary compaction).
        self.metrics["slot_steps"] += len(run.reqs)
        self.metrics["active_slot_steps"] += len(run.active)
        self._emit(run, toks, outputs, scfg)

    def _generate_cohort(self, prompts: Sequence[Any], max_new: List[int],
                         scfg: SamplingConfig) -> List[List[int]]:
        """Continuous batching at cohort granularity: admissions
        (prefills) interleave with one decode step per live cohort per
        tick, and the resident KV footprint stays inside the planned
        budget throughout (checked every tick)."""
        reqs = [self._make_request(p, n) for p, n in zip(prompts, max_new)]
        self._stream_ix = {r.rid: i for i, r in enumerate(reqs)}
        for r in reqs:
            self.scheduler.submit(r)
            self._t_submit[r.rid] = time.monotonic()
            self.tracer.instant("submit", tid=r.rid + 1,
                                args={"rid": r.rid,
                                      "prompt": r.prompt_len})
        outputs: Dict[int, List[int]] = {r.rid: [] for r in reqs}
        runs: Dict[int, _Run] = {}
        gen = make_generator(scfg, self.device)
        while self.scheduler.has_work():
            progressed = False
            for cid, batch in self.scheduler.admit():
                runs[cid] = self._prefill_cohort(cid, batch, outputs, scfg,
                                                 gen)
                progressed = True
            for cid in sorted(runs):
                run = runs.get(cid)
                if run is None:
                    continue            # evicted by a sibling's growth
                if not run.active:
                    del runs[cid]
                    continue
                self._decode_cohort(run, runs, outputs, scfg, gen)
                progressed = True
                if not run.active:
                    del runs[cid]
            if self.scheduler.allocated_bytes > self.scheduler.budget_bytes:
                raise RuntimeError("resident KV exceeded the plan")
            self.scheduler.assert_reconciled()
            if not progressed:
                raise RuntimeError("scheduler stalled with pending work")
        self.metrics["peak_resident_bytes"] = self.scheduler.peak_bytes
        self.metrics["pages_allocated"] = self.scheduler.pages_allocated
        self.metrics["pages_released"] = self.scheduler.pages_released
        self._finalize_utilization()
        return [outputs[r.rid] for r in reqs]

    # ------------------------------------------------------- paged batching
    def _prefix_on(self) -> bool:
        """Whether the paged engine runs the radix prefix cache: asked for,
        and the family's prefix KV is exactly reusable across requests
        (``serve.prefix.PREFIX_FAMILIES``)."""
        return (self.policy.prefix_cache == "radix"
                and self.cfg.family in PREFIX_FAMILIES)

    def _paged_slots(self, reqs: List[Request]) -> int:
        """Decode-batch width: ``max_slots`` capped at the trace.  With the
        prefix cache on, ``max_slots`` whatever the call's size: the
        session (and the prefixes it caches) is keyed by the geometry, so
        a call of one request and a later call of eight share it.  (The
        reference caps it at the trace there too, and rebuilds its session
        -- dropping the tree -- when the request count changes.)"""
        if self._prefix_on():
            return max(1, self.policy.max_slots)
        return max(1, min(self.policy.max_slots, len(reqs)))

    def _paged_geometry(self, reqs: List[Request], n_slots: int):
        """Pool geometry from the plan: the table width is the plan's
        per-slot page bound, stretched to the longest submitted request;
        the physical pool is the KV budget in pages, capped at what the
        slots can ever pin (plus the null page).  With the prefix cache on,
        the cap doubles (still inside the budget): cached prefixes occupy
        pool pages beside the live slots' working set, up to
        ``plan.prefix_budget()``.  A token-free family (xLSTM) gets a
        one-page table and the null page plus one."""
        page = self.page
        if page.page_bytes <= 0:
            return 1, 2
        ptab = self.plan.page_table() or {}
        need = max(page.pages_for(r.prompt_len + r.max_new + 1)
                   for r in reqs)
        pages_per_slot = max(int(ptab.get("pages_per_slot") or 1), need)
        budget_pages = max(1, self.budget_bytes // page.page_bytes)
        slot_pages = n_slots * pages_per_slot
        extra = 0
        if self._prefix_on():
            extra = min((self.plan.prefix_budget() or 0) // page.page_bytes,
                        slot_pages)
        pages_total = 1 + min(budget_pages, slot_pages + extra)
        return pages_per_slot, pages_total

    def _ensure_paged_session(self, n_slots: int, pages_per_slot: int,
                              pages_total: int) -> _PagedSession:
        """The persistent radix session (pool + pooled cache + tree) for
        this geometry, created or rebuilt on a geometry change (the import
        path materializes it before any generate call).  On a mesh its
        cache is placed here, once, by the steps of ``n_slots``: every
        later call, import and export sees the placed buffers."""
        key = (n_slots, pages_per_slot, pages_total)
        sess = self._paged_session
        if sess is not None and sess.key == key:
            return sess
        self._paged_session = None      # let the old buffers go first
        pool = PagePool(pages_total, obs=self.obs, tracer=self.tracer)
        cache = self._session_steps(n_slots).place_cache(init_paged_cache(
            self.cfg, n_slots, pages_total, self.page.page_tokens,
            pages_per_slot, self.dtype, self.device))
        budget = self.plan.prefix_budget()
        if not budget:                    # no page level (xLSTM)
            budget = self.budget_bytes
        # Pages live in the pool; snapshots are allocations of their own
        # on the card.  They share the KV budget with the pool (the rest
        # of the post-weights HBM is the activations' headroom), so their
        # cap is that budget less what the pool and the slots' state rows
        # already hold.
        has_state = self.cfg.family in STATE_FAMILIES
        held = _state_nbytes({"pool": cache["pool"],
                              "state": cache["state"]})
        prefix = RadixPrefixCache(
            self.page.page_tokens, max(0, self.page.page_bytes), budget,
            pool, has_state=has_state, obs=self.obs, tracer=self.tracer,
            state_budget_bytes=max(0, self.budget_bytes - held)
            if has_state else None)
        self._paged_session = _PagedSession(key, pool, cache, prefix)
        return self._paged_session

    def _session_steps(self, n_slots: int):
        """The paged steps for ``n_slots``: off a mesh one set serves every
        slot count; on a mesh the slots' data sharding depends on it."""
        return self.steps if self.mesh is None else self._paged_steps(n_slots)

    def _snapshot(self, cache: PyTree, slot: int, clone: bool = True
                  ) -> Dict[str, Any]:
        """One slot's recurrent state (the family's ``STATE_GROUPS``) as
        clones on the card: ``{group: {name: rows}}`` (views of the rows
        with ``clone=False``, to size a snapshot)."""
        return {g: {k: slot_rows(buf, slot).clone() if clone
                    else slot_rows(buf, slot)
                    for k, buf in cache["state"][g].items()}
                for g in STATE_GROUPS.get(self.cfg.family, ())}

    @staticmethod
    def _apply_prefix_hit(cache: PyTree, slot: int, hit: PrefixHit
                          ) -> PyTree:
        """Realize a ``PrefixHit`` on the cache, in place, queued on the
        current stream before the suffix's first chunk: copy the CoW
        source page into the slot's private copy (every pool buffer, the
        only page-sized copy of the hit path) and restore the state
        snapshot into the slot's state rows.  Shared full pages need no
        device work: the slot's page table already points at them.  On a
        mesh both happen on each rank's own shard."""
        if hit.cow is not None:
            src, dst = hit.cow
            for buf in cache["pool"].values():
                copy_page(buf, src, dst)
        for g, rows in (hit.state or {}).items():
            for k, value in rows.items():
                set_slot_rows(cache["state"][g][k], slot, value)
        return cache

    # --------------------------------------------------- page export/import
    def export_pages(self, tokens) -> Optional[Dict[str, Any]]:
        """Serialize the radix-cached KV pages covering ``tokens``' leading
        page-aligned blocks (run ``generate`` first so the prompt's pages
        are published to the tree).  Returns ``{"tokens", "page_tokens",
        "pages", "snaps"}``: ``pages`` a list of per-page ``{buffer:
        np.ndarray}`` dicts in logical order, ``snaps`` the state snapshots
        by page-boundary token count as ``{group: {name: np.ndarray}}``.
        None when nothing is cached (prefix cache off, family not
        prefix-cacheable, or a cold tree)."""
        sess = self._paged_session
        if sess is None:
            return None
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        covered, pids, snaps = sess.prefix.match(toks)
        if covered <= 0:
            return None
        return {
            "tokens": toks[:covered].tolist(),
            "page_tokens": int(self.page.page_tokens),
            "pages": export_pool_pages(sess.cache, pids),
            "snaps": {n: {g: {k: host_array(v) for k, v in rows.items()}
                          for g, rows in snap.items()}
                      for n, snap in snaps.items()},
        }

    def import_pages(self, tokens, payloads, snaps=None) -> int:
        """Install serialized KV pages into this engine's pool and radix
        tree: allocate local pages, write the payload buffers, publish the
        chain so the next ``generate`` sharing the prefix starts at its
        end.  Returns the number of prompt tokens now resident.

        Requires ``ServePolicy(prefix_cache="radix")``, a prefix-cacheable
        family, and ``policy.max_len`` bounding every later request (a
        geometry change rebuilds the session and drops imported pages)."""
        if not (self.batching == "paged" and self._prefix_on()):
            raise ValueError("import_pages needs paged batching, "
                             "ServePolicy(prefix_cache='radix') and a "
                             "prefix-cacheable family")
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        req = self._make_request(toks, self.policy.max_new_tokens,
                                 paged=True)
        self._next_rid -= 1               # synthetic request: no rid burn
        n_slots = self._paged_slots([req])
        pages_per_slot, pages_total = self._paged_geometry([req], n_slots)
        sess = self._ensure_paged_session(n_slots, pages_per_slot,
                                          pages_total)
        pool, prefix = sess.pool, sess.prefix
        n = len(payloads)
        if n == 0:
            return 0
        pids = pool.alloc(n)
        if pids is None:
            prefix.release_pages(need=n)
            pids = pool.alloc(n)
        if pids is None:
            raise RuntimeError(
                f"page pool ({pool.pages_total - 1} pages) cannot hold a "
                f"{n}-page import; raise kv_budget_bytes")
        install_pool_pages(sess.cache, pids, payloads)
        state = sess.cache["state"]
        on_card = {int(n_tok): {g: {k: place_slot_rows(
            state[g][k], torch.as_tensor(np.asarray(v)).to(
                state[g][k].device, state[g][k].dtype))
            for k, v in rows.items()} for g, rows in snap.items()}
            for n_tok, snap in (snaps or {}).items()}
        prefix.insert(toks, list(pids), snaps=on_card)
        # The tree now holds one reference per inserted page; drop ours
        # (uninserted tail pages -- budget pressure -- return to the pool).
        pool.free(pids)
        return int(prefix.match(toks)[0])

    def _generate_paged(self, prompts: Sequence[Any], max_new: List[int],
                        scfg: SamplingConfig) -> List[List[int]]:
        """Per-slot continuous batching over the global page pool.

        A fixed batch of decode slots shares ONE page pool.  Prefill is
        CHUNKED: a new request's prompt is cut into planned-page-sized
        chunks written straight into the slot's pool pages, and every tick
        runs at most one chunk per prefilling slot before the decode step
        for the resident slots, so a long prompt never blocks decode for
        more than one chunk.  A finished slot's pages free immediately and
        the slot is backfilled mid-flight.  With the prefix cache on, the
        pool, cache and tree persist across calls (``_PagedSession``), a
        hit starts a slot after its cached prefix, and every finished
        prefill publishes its full prompt pages to the tree.
        """
        dev = self.device
        reqs = [self._make_request(p, n, paged=True)
                for p, n in zip(prompts, max_new)]
        self._stream_ix = {r.rid: i for i, r in enumerate(reqs)}
        outputs: Dict[int, List[int]] = {r.rid: [] for r in reqs}
        n_slots = self._paged_slots(reqs)
        page = self.page
        window = self.cfg.sliding_window
        pages_per_slot, pages_total = self._paged_geometry(reqs, n_slots)
        enc_max = max(r.group[1] for r in reqs)   # longest encoder (enc_dec)
        steps = self._session_steps(n_slots)
        if self._prefix_on():
            # Cross-call persistence: the pool's refcounts, the cached
            # prefixes' pages and the radix tree survive between generate
            # calls as long as the geometry matches (the cache placed once,
            # when the session was made).
            sess = self._ensure_paged_session(n_slots, pages_per_slot,
                                              pages_total)
            pool, cache, prefix = sess.pool, sess.cache, sess.prefix
        else:
            pool = PagePool(pages_total, obs=self.obs, tracer=self.tracer)
            cache = steps.place_cache(init_paged_cache(
                self.cfg, n_slots, pages_total, page.page_tokens,
                pages_per_slot, self.dtype, dev, enc_len=enc_max))
            prefix = None
        params = self._params_for(steps)
        sched = PagedScheduler(pool, page, n_slots, pages_per_slot,
                               window=window, prefix=prefix)
        self._live_pool = pool          # stats() reads these while
        self._live_sched = sched        # generate runs
        gen = make_generator(scfg, dev)
        self.metrics["pages_total"] = pages_total - 1     # usable pages
        self.metrics["pages_per_slot"] = pages_per_slot
        # Chunk length: the planner's page, so every full chunk fills one
        # fresh page; "monolithic" is one whole-prompt chunk.
        chunk_tokens = self.plan.chunk_tokens() or page.page_tokens
        if self.policy.prefill == "monolithic":
            chunk_tokens = 0
        trace = RingLog(maxlen=self.LOG_CAPACITY)
        self.metrics["interleave"] = trace

        table_np = np.zeros((n_slots, pages_per_slot), np.int32)
        pos_np = np.zeros((n_slots,), np.int32)
        next_np = np.zeros((n_slots, 1), np.int64)
        ever_occupied: set = set()
        requeued: set = set()           # rids re-admitting after preemption
        prefills: Dict[int, int] = {}   # slot -> prompt tokens prefilled
        chunk_snaps: Dict[int, Dict[int, Any]] = {}  # slot -> {tokens: state}
        snaps_refused: set = set()      # slots whose snapshot was refused
        snap_bytes = _state_nbytes(self._snapshot(cache, 0, clone=False)) \
            if prefix is not None and prefix.has_state else 0
        peak_pages = 0
        t0 = time.monotonic()
        token_times: Dict[int, RingLog] = {
            r.rid: RingLog(maxlen=self.TOKEN_TIMES_CAPACITY) for r in reqs}
        self.metrics["token_times"] = token_times
        self.metrics["start_time"] = t0
        for r in reqs:
            sched.submit(r)
            self._t_submit[r.rid] = time.monotonic()
            self.tracer.instant("submit", tid=r.rid + 1,
                                args={"rid": r.rid,
                                      "prompt": r.prompt_len})

        def take_snaps(i: int) -> Optional[Dict[int, Any]]:
            """The slot's pending snapshots, their reservation released."""
            snaps = chunk_snaps.pop(i, None)
            snaps_refused.discard(i)
            if snaps:
                prefix.release(len(snaps) * snap_bytes)
            return snaps

        def clear_slot(i: int) -> None:
            table_np[i] = 0
            pos_np[i] = 0
            next_np[i, 0] = 0

        def push_table(i: int) -> None:
            row = [p if p is not None else 0 for p in sched.slots[i].pages]
            table_np[i, :len(row)] = row
            table_np[i, len(row):] = 0

        def assert_private(s, lo: int, hi: int, what: str) -> None:
            """CoW safety, on the host: every page holding positions
            ``[lo, hi)`` of slot ``s`` is private (refcount 1) -- shared
            prefix pages sit strictly below the suffix front."""
            for j in range(lo // page.page_tokens,
                           -(-hi // page.page_tokens)):
                p = s.pages[j] if j < len(s.pages) else None
                assert p is None or pool.refcount(p) == 1, \
                    f"{what} would write shared page {p} " \
                    f"(rc={pool.refcount(p)})"

        def emit_token(slot: int, rid: int, max_new_bound: int,
                       tok: int) -> None:
            """Deliver one sampled token for a slot: record it, stream it,
            queue it as the slot's next input, reclaim out-of-window pages,
            and retire the slot when its request is done."""
            outputs[rid].append(tok)
            now = time.monotonic()
            times = token_times[rid]
            if len(outputs[rid]) == 1:
                self.tracer.instant("first_token", tid=rid + 1,
                                    args={"rid": rid, "slot": slot})
                self.obs.observe(
                    "ttft_s", now - self._t_submit.get(rid, t0))
            elif len(times):
                self.obs.observe("inter_token_s", now - times[-1])
            times.append(now)
            self._notify(rid, tok)
            self.metrics["tokens"] += 1
            next_np[slot, 0] = tok
            if window:
                sched.reclaim_window(slot, window)
            if len(outputs[rid]) >= max_new_bound or \
                    (scfg.eos_id is not None and tok == scfg.eos_id):
                sched.finish(slot)
                clear_slot(slot)
                self.tracer.complete(
                    "request", self._t_submit.get(rid, t0), now,
                    tid=rid + 1,
                    args={"rid": rid, "tokens": len(outputs[rid])})

        def preempt(victim: int) -> None:
            """Recompute preemption: the victim's tokens (and any partial
            prefill) regenerate from scratch after re-admission."""
            vreq = sched.evict(victim)
            self.obs.inc("tokens_recomputed", len(outputs[vreq.rid]))
            self.tracer.instant(
                "preempt", tid=vreq.rid + 1,
                args={"rid": vreq.rid, "slot": victim,
                      "tokens_lost": len(outputs[vreq.rid])})
            outputs[vreq.rid] = []
            token_times[vreq.rid].clear()
            self._notify(vreq.rid, None)
            requeued.add(vreq.rid)
            prefills.pop(victim, None)
            take_snaps(victim)
            clear_slot(victim)
            self.metrics["evictions"] += 1

        while sched.has_work():
            progressed = False
            # Capacity FIRST, oldest request first: an older slot preempts
            # strictly-younger victims (recompute); a slot with no younger
            # victim STALLS this tick, so the oldest slot always progresses.
            stalled: set = set()
            for i in sorted(sched.active(),
                            key=lambda j: sched.slots[j].rid):
                if sched.slots[i] is None or i in prefills:
                    continue                  # evicted by an older grower
                while not sched.ensure_capacity(i):
                    if sched.table_full(i):
                        stalled.add(i)    # eviction cannot widen the table
                        self.metrics["stalls"] += 1
                        break
                    victim = sched.victim(i)
                    if victim is None:
                        if len(sched.active()) == 1:
                            raise RuntimeError(
                                f"page pool ({pool.pages_total - 1} pages)"
                                f" cannot hold one growing sequence; "
                                f"raise kv_budget_bytes")
                        stalled.add(i)
                        self.metrics["stalls"] += 1
                        break
                    preempt(victim)

            # Admission: a slot + its first page; the prompt streams in
            # below, one chunk per tick, straight into pool pages.  Enc-dec
            # runs its encoder once here and installs the cross K/V into
            # the slot's state rows.  A prefix hit starts the slot at
            # ``hit.tokens`` with the shared pages already in its table:
            # copy the divergent page, restore the state snapshot, and
            # prefill covers only the suffix.
            for slot, req, _pages, hit in sched.admit():
                now = time.monotonic()
                t_sub = self._t_submit.get(req.rid, t0)
                self.tracer.complete("queue_wait", t_sub, now,
                                     tid=req.rid + 1,
                                     args={"rid": req.rid, "slot": slot})
                self.obs.observe("queue_wait_s", now - t_sub)
                cache = reset_slot(self.cfg, cache, slot,
                                   cross_kv=self._encode_req(req),
                                   enc_len=req.group[1])
                table_np[slot] = 0
                push_table(slot)
                pos_np[slot] = sched.slots[slot].pos
                next_np[slot, 0] = 0
                prefills[slot] = sched.slots[slot].pos
                if hit is not None:
                    cache = self._apply_prefix_hit(cache, slot, hit)
                    self.metrics["prefix_hits"] += 1
                    self.metrics["prefix_hit_tokens"] += hit.tokens
                    self.metrics["pages_saved"] += \
                        hit.tokens // page.page_tokens
                    if hit.cow is not None:
                        self.metrics["cow_copies"] += 1
                        self.tracer.instant(
                            "cow_copy", tid=req.rid + 1,
                            args={"rid": req.rid, "slot": slot,
                                  "src": hit.cow[0], "dst": hit.cow[1]})
                elif prefix is not None:
                    self.metrics["prefix_misses"] += 1
                # A backfill is a NEW request taking a previously used slot
                # mid-flight; a preempted request's re-admission is not.
                if slot in ever_occupied and req.rid not in requeued:
                    self.metrics["backfills"] += 1
                requeued.discard(req.rid)
                ever_occupied.add(slot)
                progressed = True

            # Chunk phase: one chunk per prefilling slot per tick, BEFORE
            # the decode step.  A prefilling slot rides through the decode
            # batch; its write at the chunk front is overwritten by the
            # next chunk.
            for slot in sorted(prefills):
                s = sched.slots[slot]
                if s is None or slot not in prefills:
                    continue                  # preempted by a sibling chunk
                req, plen = s.req, s.req.prompt_len
                done = prefills[slot]
                # A prefix hit can start mid-page; the first suffix chunk
                # realigns to the chunk grid.
                c = plen - done if chunk_tokens <= 0 else \
                    min(chunk_tokens - done % chunk_tokens, plen - done)
                if window and prefix is None:
                    # Behind the front.  With the prefix cache on, prompt
                    # pages must survive to insertion below: window
                    # reclaim resumes at decode (the tree's reference then
                    # keeps them resident).
                    sched.reclaim_window(slot, window)
                # The final chunk also makes room for the first decode
                # token: the slot joins this tick's decode batch, whose
                # write at position plen would land on the null page when
                # the prompt ends on a page boundary.  A request of one
                # new token retires at its first token and never decodes.
                upto = done + c + (1 if done + c >= plen
                                   and req.max_new > 1 else 0)
                grew = True
                while not sched.ensure_capacity(slot, upto=upto):
                    if sched.table_full(slot):
                        raise RuntimeError(
                            f"slot {slot}: prompt needs more than the "
                            f"{pages_per_slot}-page table")
                    victim = sched.victim(slot)
                    if victim is None:
                        if len(sched.active()) == 1:
                            raise RuntimeError(
                                f"page pool ({pool.pages_total - 1} pages)"
                                f" cannot hold one prefill chunk; "
                                f"raise kv_budget_bytes")
                        stalled.add(slot)
                        self.metrics["stalls"] += 1
                        grew = False
                        break
                    preempt(victim)
                if not grew:
                    continue                  # retry the chunk next tick
                peak_pages = max(peak_pages, pool.used_pages)
                if prefix is not None and page.page_bytes > 0:
                    assert_private(s, done, done + c, "chunk")
                push_table(slot)
                cache["table"] = torch.from_numpy(table_np).to(dev)
                toks = torch.from_numpy(
                    req.features["tokens"][done:done + c].astype(
                        np.int64))[None].to(dev)
                tc0 = time.monotonic()
                logits, cache = steps.prefill_chunk(
                    params, cache, toks, done, slot)
                self.tracer.complete(
                    "prefill_chunk", tc0, time.monotonic(),
                    tid=req.rid + 1,
                    args={"rid": req.rid, "slot": slot, "done": done,
                          "tokens": c})
                self.metrics["prefill_chunks"] += 1
                self.metrics["prefill_tokens"] += c
                trace.append(("chunk", slot, done, c))
                done += c
                prefills[slot] = done
                s.pos = done
                pos_np[slot] = done
                progressed = True
                if prefix is not None and prefix.has_state and \
                        done % page.page_tokens == 0 and \
                        slot not in snaps_refused:
                    # Page-boundary state snapshot, kept on the card: the
                    # radix node for this block restores it on a hit.  It
                    # is billed before it is cloned; once the tree refuses
                    # one, the chain this prompt can publish ends there.
                    if prefix.reserve(snap_bytes):
                        chunk_snaps.setdefault(slot, {})[done] = \
                            self._snapshot(cache, slot)
                    else:
                        snaps_refused.add(slot)
                if done >= plen:
                    del prefills[slot]
                    if prefix is not None:
                        self.metrics["prefix_nodes_inserted"] += \
                            prefix.insert(req.features["tokens"],
                                          list(s.pages),
                                          snaps=take_snaps(slot))
                    tok = int(sample(logits, scfg, gen)[0])
                    emit_token(slot, req.rid, req.max_new, tok)

            active = [i for i in sched.active()
                      if i not in stalled and i not in prefills]
            if active and prefix is not None and page.page_bytes > 0:
                # CoW safety for decode writes: the write position's page
                # is private (positions only grow past the shared prefix).
                for i in active:
                    pos = sched.slots[i].pos
                    assert_private(sched.slots[i], pos, pos + 1, "decode")
            if active:
                # Refresh the device page tables from the scheduler: growth
                # appended pages, window reclaim nulled out-of-window ones.
                for i in sched.active():
                    push_table(i)
                cache["table"] = torch.from_numpy(table_np).to(dev)
                cache["pos"] = torch.from_numpy(pos_np).to(dev)
                # Stalled AND prefilling slots ride through the decode
                # batch: their KV writes land on the null page or at the
                # chunk front (overwritten by the next chunk), but their
                # recurrent state (every buffer of the family's
                # ``STATE_GROUPS``: Mamba, mLSTM, sLSTM) would advance on
                # the discarded tick, so those rows are saved before the
                # step and put back after it (``slot_rows``: the slot is
                # axis 1 of a layer-stacked buffer, axis 0 of a per-slot
                # vector).  State a step only reads (enc-dec's cross K/V)
                # is not copied.
                frozen = sorted(i for i in stalled | set(prefills)
                                if sched.slots[i] is not None)
                groups = STATE_GROUPS.get(self.cfg.family, ())
                saved = None
                if frozen and groups:
                    rows = torch.tensor(frozen, device=dev)
                    saved = [(buf, slot_rows(buf, rows)) for g in groups
                             for buf in cache["state"][g].values()]
                td0 = time.monotonic()
                logits, cache = steps.decode(
                    params, cache,
                    {"tokens": torch.from_numpy(next_np).to(dev)})
                for buf, rows_before in saved or ():
                    set_slot_rows(buf, rows, rows_before)
                toks = sample(logits, scfg, gen).cpu().numpy()
                self.tracer.complete("decode_tick", td0, time.monotonic(),
                                     tid=0, args={"active": len(active)})
                trace.append(("decode", tuple(active)))
                self.metrics["decode_steps"] += 1
                self.metrics["slot_steps"] += n_slots
                self.metrics["active_slot_steps"] += len(active)
                for i in active:
                    s = sched.slots[i]
                    s.pos += 1
                    pos_np[i] = s.pos
                    emit_token(i, s.rid, s.req.max_new, int(toks[i]))
                progressed = True

            peak_pages = max(peak_pages, pool.used_pages)
            if prefix is None:
                assert pool.used_pages == sched.used_pages_by_slots(), \
                    "page pool out of sync with the slot tables"
            else:
                # Shared pages carry one refcount per mapping: every slot
                # table entry plus every radix-tree node.
                assert pool.total_refs == sched.used_pages_by_slots() \
                    + prefix.n_pages, "refcount ledger out of sync"
            assert pool.pages_allocated - pool.pages_released == \
                pool.used_pages, "page accounting leak"
            if not progressed:
                raise RuntimeError("scheduler stalled with pending work")

        self.metrics["peak_resident_bytes"] = peak_pages * page.page_bytes
        self.metrics["peak_pages"] = peak_pages
        self.obs.set_max("pool_peak_pages", peak_pages, unit="pages")
        self.metrics["pages_allocated"] = pool.pages_allocated
        self.metrics["pages_released"] = pool.pages_released
        self.obs.inc("interleave_dropped", trace.dropped)
        self.obs.inc("token_times_dropped",
                     sum(t.dropped for t in token_times.values()))
        if prefix is not None:
            seen = prefix.hits + prefix.misses
            self.metrics["prefix_hit_rate"] = \
                prefix.hits / seen if seen else 0.0
            self.metrics["prefix_resident_pages"] = prefix.n_pages
            self.metrics["prefix_resident_bytes"] = prefix.resident_bytes
            self.metrics["prefix_evicted_pages"] = prefix.evicted_pages
            self.metrics["prefix_budget_bytes"] = prefix.budget_bytes
            self.metrics["prefix_peak_state_bytes"] = prefix.peak_state_bytes
            assert prefix.pending_bytes == 0, "snapshot bytes left pending"
            self._paged_session.cache = cache   # carry the pages forward
        self._finalize_utilization()
        return [outputs[r.rid] for r in reqs]

