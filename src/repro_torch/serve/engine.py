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
    whole-prompt chunk instead).  A sliding-window family (Mixtral) frees
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
three streams).  ``prefix_cache="radix"`` waits for a later slice and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import HierarchicalPlan, PlanPolicy, Workload, \
    plan_run
from repro_torch.models.model import Model
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
    init_paged_cache,
    reset_slot,
    set_slot_rows,
    slot_rows,
)
from repro_torch.serve.sampling import SamplingConfig, make_generator, sample
from repro_torch.serve.scheduler import Request, ServeScheduler
from repro_torch.serve.steps import ServeSteps, make_paged_steps, \
    make_serve_steps

PyTree = Any


# ---------------------------------------------------------------------------
# The decode plan
# ---------------------------------------------------------------------------


def plan_decode(
    cfg: ModelConfig,
    *,
    max_len: int = 4096,
    batch: int = 1,
    dtype_bytes: int = 2,
    spec=None,
) -> HierarchicalPlan:
    """``plan_run`` over the decode workload on one card.

    The shardable state is the resident KV of ``batch`` sequences of
    ``max_len`` tokens; the weights, the per-slot activation stream and
    any per-request state ride along as the replicated reserve.  The
    hierarchy is ``spec.hierarchy()`` (default: an H100 SXM).
    """
    tok_bytes, layers, heads = kv_token_bytes(cfg, dtype_bytes)
    kv_state = tok_bytes * max_len * batch
    weights = cfg.param_count() * dtype_bytes
    stream = batch * cfg.d_model * dtype_bytes * 4
    fixed = batch * request_state_bytes(cfg, enc_len=max_len,
                                        dtype_bytes=dtype_bytes)
    if spec is None:
        from repro_torch.hw.h100 import h100_spec
        spec = h100_spec()
    return plan_run(
        spec.hierarchy(),
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
        PlanPolicy(n_workers=1),
    )


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
    ``prefix_cache``: only "off" is ported.
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
    seeded random weights from ``seed``.
    """

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
    ):
        self.device = resolve_device(device)
        if policy.prefix_cache != "off":
            raise NotImplementedError(
                "repro_torch has no prefix cache yet; use "
                "ServePolicy(prefix_cache='off')")
        self.cfg = cfg
        self.policy = policy
        self.dtype = dtype if dtype is not None else torch.float32
        self._dtype_bytes = torch.tensor([], dtype=self.dtype).element_size()
        self.plan = plan_decode(
            cfg, max_len=policy.max_len, batch=policy.max_slots,
            dtype_bytes=self._dtype_bytes, spec=spec)
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
        self.params = (params if params is not None
                       else self.model.init(seed, self.device, self.dtype))
        self.budget_bytes = self._kv_budget()
        # Each engine builds only its own steps and bookkeeping: the paged
        # engine its pool steps, the cohort engine its scheduler (its
        # contiguous-cache steps are made per cohort, at its capacity).
        paged = self.batching == "paged"
        self.steps = make_paged_steps(self.model, self.dtype) if paged \
            else None
        self.scheduler = None if paged else ServeScheduler(
            self.budget_bytes, self.page, max_slots=policy.max_slots)
        self._live_pool: Optional[PagePool] = None
        self._live_sched: Optional[PagedScheduler] = None
        self._next_rid = 0
        self._t_submit: Dict[int, float] = {}   # rid -> submit monotonic s
        # The metrics spine: one typed Registry and one Tracer per engine.
        # ``engine.metrics`` is a MetricsView over the registry with the
        # JAX engine's keys.
        self.obs = Registry()
        self.tracer = Tracer(capacity=self.TRACE_CAPACITY)
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

    # ------------------------------------------------------------- plan reads
    def _kv_budget(self) -> int:
        """The KV budget in logical bytes: ``kv_fraction`` of the card's
        HBM left after one copy of the weights (the NVLINK level's budget
        is one card's HBM)."""
        if self.policy.kv_budget_bytes is not None:
            return int(self.policy.kv_budget_bytes)
        mesh = self.plan.level("NVLINK")
        hbm = mesh.budget_bytes if mesh is not None else \
            self.plan.leaf().budget_bytes
        weights = self.cfg.param_count() * self._dtype_bytes
        budget = int(self.policy.kv_fraction * max(0, hbm - weights))
        return max(self.page.page_bytes, budget)

    # -------------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, Any]:
        """One telemetry dict: pool, slots, tokens (live pool when a
        generate call is running, else the last run's geometry, else the
        plan's ``page_table``)."""
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
        return {
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
        }

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
    ) -> List[List[int]]:
        """Serve ``prompts`` (token-id sequences, or the family's dict
        prompts: see the module docstring), returning each request's
        generated token ids in submission order.  ``max_new_tokens`` is
        one int for all requests or a per-request sequence."""
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
        if self.batching == "paged":
            return self._generate_paged(prompts, max_new, scfg)
        return self._generate_cohort(prompts, max_new, scfg)

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
        ss = make_serve_steps(self.model, capacity, self.dtype)
        batch = self._stack_features(reqs)
        for r in reqs:
            now = time.monotonic()
            t_sub = self._t_submit.get(r.rid, now)
            self.tracer.complete("queue_wait", t_sub, now, tid=r.rid + 1,
                                 args={"rid": r.rid, "cohort": cid})
            self.obs.observe("queue_wait_s", now - t_sub)
        tp0 = time.monotonic()
        logits, cache = ss.prefill(self.params, batch)
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
        run.cache = take_slots(run.cache, idx)
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
            del runs[victim]
            self.metrics["evictions"] += 1
        run.cache = grow_cache(self.cfg, run.cache, needed)
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
        logits, run.cache = run.steps.decode(self.params, run.cache, batch)
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
    def _paged_slots(self, reqs: List[Request]) -> int:
        """Decode-batch width: ``max_slots`` capped at the trace."""
        return max(1, min(self.policy.max_slots, len(reqs)))

    def _paged_geometry(self, reqs: List[Request], n_slots: int):
        """Pool geometry from the plan: the table width is the plan's
        per-slot page bound, stretched to the longest submitted request;
        the physical pool is the KV budget in pages, capped at what the
        slots can ever pin (plus the null page).  A token-free family
        (xLSTM) gets a one-page table and the null page plus one."""
        page = self.page
        if page.page_bytes <= 0:
            return 1, 2
        ptab = self.plan.page_table() or {}
        need = max(page.pages_for(r.prompt_len + r.max_new + 1)
                   for r in reqs)
        pages_per_slot = max(int(ptab.get("pages_per_slot") or 1), need)
        budget_pages = max(1, self.budget_bytes // page.page_bytes)
        pages_total = 1 + min(budget_pages, n_slots * pages_per_slot)
        return pages_per_slot, pages_total

    def _generate_paged(self, prompts: Sequence[Any], max_new: List[int],
                        scfg: SamplingConfig) -> List[List[int]]:
        """Per-slot continuous batching over the global page pool.

        A fixed batch of decode slots shares ONE page pool.  Prefill is
        CHUNKED: a new request's prompt is cut into planned-page-sized
        chunks written straight into the slot's pool pages, and every tick
        runs at most one chunk per prefilling slot before the decode step
        for the resident slots, so a long prompt never blocks decode for
        more than one chunk.  A finished slot's pages free immediately and
        the slot is backfilled mid-flight.
        """
        dev = self.device
        reqs = [self._make_request(p, n, paged=True)
                for p, n in zip(prompts, max_new)]
        outputs: Dict[int, List[int]] = {r.rid: [] for r in reqs}
        n_slots = self._paged_slots(reqs)
        page = self.page
        window = self.cfg.sliding_window
        pages_per_slot, pages_total = self._paged_geometry(reqs, n_slots)
        enc_max = max(r.group[1] for r in reqs)   # longest encoder (enc_dec)
        pool = PagePool(pages_total, obs=self.obs, tracer=self.tracer)
        cache = init_paged_cache(self.cfg, n_slots, pages_total,
                                 page.page_tokens, pages_per_slot,
                                 self.dtype, dev, enc_len=enc_max)
        sched = PagedScheduler(pool, page, n_slots, pages_per_slot,
                               window=window)
        self._live_pool = pool          # stats() reads these while
        self._live_sched = sched        # generate runs
        steps = self.steps
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

        def clear_slot(i: int) -> None:
            table_np[i] = 0
            pos_np[i] = 0
            next_np[i, 0] = 0

        def push_table(i: int) -> None:
            row = [p if p is not None else 0 for p in sched.slots[i].pages]
            table_np[i, :len(row)] = row
            table_np[i, len(row):] = 0

        def emit_token(slot: int, rid: int, max_new_bound: int,
                       tok: int) -> None:
            """Deliver one sampled token for a slot: record it, queue it as
            the slot's next input, reclaim out-of-window pages, and retire
            the slot when its request is done."""
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
            requeued.add(vreq.rid)
            prefills.pop(victim, None)
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
            # the slot's state rows.
            for slot, req, _pages in sched.admit():
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
                c = plen - done if chunk_tokens <= 0 else \
                    min(chunk_tokens - done % chunk_tokens, plen - done)
                if window:
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
                push_table(slot)
                cache["table"] = torch.from_numpy(table_np).to(dev)
                toks = torch.from_numpy(
                    req.features["tokens"][done:done + c].astype(
                        np.int64))[None].to(dev)
                tc0 = time.monotonic()
                logits, cache = steps.prefill_chunk(
                    self.params, cache, toks, done, slot)
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
                if done >= plen:
                    del prefills[slot]
                    tok = int(sample(logits, scfg, gen)[0])
                    emit_token(slot, req.rid, req.max_new, tok)

            active = [i for i in sched.active()
                      if i not in stalled and i not in prefills]
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
                    self.params, cache,
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
            assert pool.used_pages == sched.used_pages_by_slots(), \
                "page pool out of sync with the slot tables"
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
        self._finalize_utilization()
        return [outputs[r.rid] for r in reqs]
