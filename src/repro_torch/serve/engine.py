"""``ServeEngine`` -- the plan-driven paged serving engine (the port of
``repro.serve.engine`` for one card).

``ServeEngine(cfg, policy=ServePolicy(batching="paged")).generate(prompts)``:

  * ``plan_decode`` builds the decode workload (per-token KV bytes x heads
    x layers, ``core.plan.Workload``) and walks the card's hierarchy once:
    the NVLINK level chooses the KV head sharding (``kv_shard``), the SMEM
    level the page size (``page_tokens``) and the pool bound.
  * ``serve.kvcache.PageSpec`` turns the page into the allocation granule.
  * ``serve.pages`` owns the global page pool and slot-level admission:
    a fixed batch of decode slots, per-slot page tables, a finished slot
    backfilled by a new request mid-flight.
  * Prefill is CHUNKED: a prompt is cut into page-sized chunks written
    straight into the slot's pool pages and interleaved with decode ticks
    (``prefill="monolithic"`` runs one whole-prompt chunk instead).

``batching="cohort"`` and ``prefix_cache="radix"`` wait for later slices
and raise ``NotImplementedError``.
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
    kv_token_bytes,
    page_spec_from_plan,
    request_state_bytes,
)
from repro_torch.serve.pages import (
    PAGED_FAMILIES,
    PagePool,
    PagedScheduler,
    init_paged_cache,
    reset_slot,
)
from repro_torch.serve.sampling import SamplingConfig, make_generator, sample
from repro_torch.serve.scheduler import Request
from repro_torch.serve.steps import make_paged_steps

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
    batching ("cohort" is not ported yet and raises).
    ``prefill``: "chunked" cuts prompts into planned-page-sized chunks
    interleaved with decode ticks; "monolithic" runs one whole-prompt
    chunk (identical tokens, no interleave).  ``prefix_cache``: only
    "off" is ported.
    """

    max_new_tokens: int = 16
    max_slots: int = 8              # decode slots
    max_len: int = 4096             # per-sequence planning bound (tokens)
    kv_fraction: float = 0.8        # share of post-weights HBM given to KV
    kv_budget_bytes: Optional[int] = None   # override the planned budget
    batching: str = "paged"         # | "cohort"
    prefill: str = "chunked"        # | "monolithic"
    prefix_cache: str = "off"       # | "radix"
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    def __post_init__(self):
        if self.batching not in ("cohort", "paged"):
            raise ValueError(f"unknown batching {self.batching!r}; "
                             f"one of ('cohort', 'paged')")
        if self.prefill not in ("chunked", "monolithic"):
            raise ValueError(f"unknown prefill {self.prefill!r}; "
                             f"one of ('chunked', 'monolithic')")
        if self.prefix_cache not in ("off", "radix"):
            raise ValueError(f"unknown prefix_cache {self.prefix_cache!r}; "
                             f"one of ('off', 'radix')")


class ServeEngine:
    """Plan-driven paged serving engine (see module docstring).

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
        if policy.batching == "cohort":
            raise NotImplementedError(
                "repro_torch has no cohort engine yet; use "
                "ServePolicy(batching='paged')")
        if policy.prefix_cache != "off":
            raise NotImplementedError(
                "repro_torch has no prefix cache yet; use "
                "ServePolicy(prefix_cache='off')")
        if cfg.family not in PAGED_FAMILIES:
            raise NotImplementedError(
                f"repro_torch serves families {PAGED_FAMILIES} so far; "
                f"{cfg.arch!r} is {cfg.family!r}")
        self.cfg = cfg
        self.policy = policy
        self.dtype = dtype if dtype is not None else torch.float32
        self._dtype_bytes = torch.tensor([], dtype=self.dtype).element_size()
        self.plan = plan_decode(
            cfg, max_len=policy.max_len, batch=policy.max_slots,
            dtype_bytes=self._dtype_bytes, spec=spec)
        self.page: PageSpec = page_spec_from_plan(self.plan, cfg,
                                                  self._dtype_bytes)
        self.batching = "paged"
        self.model = Model(cfg)
        self.params = (params if params is not None
                       else self.model.init(seed, self.device, self.dtype))
        self.steps = make_paged_steps(self.model, self.dtype)
        self.budget_bytes = self._kv_budget()
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
    def _make_request(self, prompt, max_new: int) -> Request:
        toks = np.asarray(prompt, dtype=np.int32).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        return Request(rid=rid, prompt_len=int(toks.shape[0]),
                       max_new=max_new, features={"tokens": toks})

    # --------------------------------------------------------------- generate
    def generate(
        self,
        prompts: Sequence[Any],
        max_new_tokens=None,
        sampling: Optional[SamplingConfig] = None,
    ) -> List[List[int]]:
        """Serve ``prompts`` (token-id sequences), returning each request's
        generated token ids in submission order.  ``max_new_tokens`` is one
        int for all requests or a per-request sequence."""
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
        return self._generate_paged(prompts, max_new, scfg)

    def _finalize_utilization(self) -> None:
        steps = self.metrics["slot_steps"]
        self.metrics["slot_utilization"] = (
            self.metrics["active_slot_steps"] / steps if steps else 0.0)

    # ------------------------------------------------------- paged batching
    def _paged_slots(self, reqs: List[Request]) -> int:
        """Decode-batch width: ``max_slots`` capped at the trace."""
        return max(1, min(self.policy.max_slots, len(reqs)))

    def _paged_geometry(self, reqs: List[Request], n_slots: int):
        """Pool geometry from the plan: the table width is the plan's
        per-slot page bound, stretched to the longest submitted request;
        the physical pool is the KV budget in pages, capped at what the
        slots can ever pin (plus the null page)."""
        page = self.page
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
        reqs = [self._make_request(p, n) for p, n in zip(prompts, max_new)]
        outputs: Dict[int, List[int]] = {r.rid: [] for r in reqs}
        n_slots = self._paged_slots(reqs)
        page = self.page
        window = self.cfg.sliding_window
        pages_per_slot, pages_total = self._paged_geometry(reqs, n_slots)
        pool = PagePool(pages_total, obs=self.obs, tracer=self.tracer)
        cache = init_paged_cache(self.cfg, n_slots, pages_total,
                                 page.page_tokens, pages_per_slot,
                                 self.dtype, dev)
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
            # below, one chunk per tick, straight into pool pages.
            for slot, req, _pages in sched.admit():
                now = time.monotonic()
                t_sub = self._t_submit.get(req.rid, t0)
                self.tracer.complete("queue_wait", t_sub, now,
                                     tid=req.rid + 1,
                                     args={"rid": req.rid, "slot": slot})
                self.obs.observe("queue_wait_s", now - t_sub)
                cache = reset_slot(self.cfg, cache, slot)
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
                grew = True
                while not sched.ensure_capacity(slot, upto=done + c):
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
                td0 = time.monotonic()
                logits, cache = steps.decode(
                    self.params, cache,
                    {"tokens": torch.from_numpy(next_np).to(dev)})
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
