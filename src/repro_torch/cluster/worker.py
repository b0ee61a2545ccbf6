"""The replica host: one worker (spawned process or thread) per
``ServeEngine``, driven by an instruction queue (the port of
``repro.cluster.worker``).

The front side never touches the engine directly: it enqueues ``(seq, op,
payload)`` instructions, and a per-replica worker loop executes them
against ONE engine it builds at its first instruction and keeps for its
lifetime (the weights and the kernels' libraries are loaded once per
worker, not per request).  Every reply is tagged with the instruction's
``seq`` so one response queue carries interleaved token streams, results
and errors; after each instruction the worker pushes an unsolicited
``ReplicaStats`` tick (``seq == _TICK``) so the router sees the replica's
pool pressure without a round trip.

Two transports share the loop verbatim:

  * ``"proc"`` -- a ``multiprocessing`` *spawn* context worker with a
    ``ctx.Queue`` pair (a CUDA context does not survive ``fork``).  The
    factory must be picklable (``EngineSpec`` / ``StubSpec``).  Each
    worker is a process of its own with its own CUDA context and caching
    allocator; a worker that exits fails its outstanding calls.
  * ``"thread"`` -- a daemon thread with ``queue.Queue``s in-process.
    Same protocol, no pickling, and the live engine is reachable for live
    telemetry (``Replica.stats`` reads ``engine.stats()`` directly, so a
    replica's free-page count moves while a request is resident).

Replicas that share one card split its HBM by ``replica_kv_budget``: each
gets one engine's planned KV budget less the other replicas' copies of
the weights and every worker's CUDA context, divided by their count.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field, fields, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: seq id of unsolicited telemetry pushes (never a real instruction).
_TICK = -1

TRANSPORTS = ("thread", "proc")

#: Card memory one spawned worker holds outside its caching allocator (its
#: CUDA context, cuBLAS's handle, the kernels' modules), reserved per
#: replica when replicas share a card.  ``cuda_context_bytes`` measures it;
#: ``chip_smoke.py`` phase 32 checks the measurement fits.
CONTEXT_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


@dataclass
class ReplicaStats:
    """One replica's telemetry tick -- the router's entire world view.

    ``free_pages``/``slots_free`` come from ``engine.stats()`` (the live
    pool when one exists); ``queued``/``active`` are front-side facts
    (instructions enqueued but unfinished) filled in by ``Replica.stats``
    -- the worker cannot see its own backlog.  ``drained`` is a router
    verdict, stamped by ``ServeCluster.stats``.  ``metrics`` is the
    engine registry's snapshot (every counter and gauge, histogram
    quantiles), forwarded on the tick; stub engines leave it empty."""

    replica: int = 0
    role: str = "serve"                 # | "prefill" | "decode"
    free_pages: int = 0
    used_pages: int = 0
    pages_total: int = 0
    slots_free: int = 0
    slots_total: int = 0
    page_tokens: int = 0
    prefix_nodes: int = 0
    prefix_pages: int = 0
    prefix_resident_bytes: int = 0
    queued: int = 0
    active: int = 0
    tokens: int = 0
    ticks: int = 0
    drained: bool = False
    metrics: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_engine(cls, engine, replica: int, role: str = "serve",
                    ticks: int = 0) -> "ReplicaStats":
        s = engine.stats()
        keep = {f.name for f in fields(cls)}
        obs = getattr(engine, "obs", None)
        snap = obs.snapshot() if obs is not None else {}
        return cls(replica=replica, role=role, ticks=ticks, metrics=snap,
                   **{k: v for k, v in s.items() if k in keep})


# ---------------------------------------------------------------------------
# Picklable engine factories (the spawn transport ships these, not engines)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineSpec:
    """A picklable ``ServeEngine`` recipe: everything a worker needs to
    build the engine on its side of the spawn.  The fields are the
    reference's; ``chip`` is a tuple of ``h100_spec`` override items
    (tests shrink ``smem_bytes`` with it), ``device`` the engine's device
    (``"cuda"``; tests pass ``"cpu"``) and ``dtype`` the name of its torch
    dtype.  Each call builds a new engine on ``seed``'s weights; the
    worker loop calls it once."""

    arch: str = "llama3.2-1b"
    reduced: bool = True
    max_new_tokens: int = 16
    max_slots: int = 1
    max_len: int = 256
    batching: str = "paged"
    prefill: str = "chunked"
    prefix_cache: str = "radix"
    kv_budget_bytes: Optional[int] = None
    seed: int = 0
    chip: Tuple[Tuple[str, Any], ...] = ()
    device: str = "cuda"
    dtype: str = "float32"

    def config(self):
        from repro_torch.configs import get_model_config

        cfg = get_model_config(self.arch)
        return cfg.reduced() if self.reduced else cfg

    def policy(self):
        from repro_torch.serve import ServePolicy

        return ServePolicy(
            max_new_tokens=self.max_new_tokens, max_slots=self.max_slots,
            max_len=self.max_len, batching=self.batching,
            prefill=self.prefill, prefix_cache=self.prefix_cache,
            kv_budget_bytes=self.kv_budget_bytes)

    def __call__(self, replica: int = 0):
        import torch

        from repro_torch.hw.h100 import h100_spec
        from repro_torch.serve import ServeEngine

        return ServeEngine(self.config(), self.policy(),
                           dtype=getattr(torch, self.dtype), seed=self.seed,
                           spec=h100_spec(**dict(self.chip)),
                           device=self.device, replica=replica)


def replica_kv_budget(spec: EngineSpec, n: int,
                      context_bytes: int = CONTEXT_BYTES) -> int:
    """The KV budget of each of ``n`` replicas of ``spec`` that share one
    card: one engine's planned budget (``serve.engine.kv_budget``, which
    already leaves one copy of the weights out of the card's HBM) less the
    other ``n - 1`` replicas' weights and ``n`` workers' ``context_bytes``
    (a thread replica shares its process's context; a spawned one holds
    its own), divided by ``n``.  The front computes it once and passes it
    as ``EngineSpec.kv_budget_bytes``; nothing shrinks it later."""
    import torch

    from repro_torch.hw.h100 import h100_spec
    from repro_torch.serve.engine import kv_budget, plan_decode

    cfg, policy = spec.config(), spec.policy()
    el = torch.tensor([], dtype=getattr(torch, spec.dtype)).element_size()
    plan = plan_decode(cfg, max_len=policy.max_len, batch=policy.max_slots,
                       dtype_bytes=el, spec=h100_spec(**dict(spec.chip)))
    whole = kv_budget(plan, cfg, el, policy.kv_fraction)
    weights = cfg.param_count() * el
    left = whole - (n - 1) * weights - n * context_bytes
    if left <= 0:
        raise ValueError(
            f"{n} replicas of {spec.arch} do not fit one card: the planned "
            f"KV budget {whole} B holds no room after {n - 1} more weight "
            f"copies of {weights} B and {n} contexts of {context_bytes} B")
    return left // n


def _context_probe(conn) -> None:
    """A spawned process's CUDA context, with cuBLAS and one of the port's
    kernel libraries loaded; reports its allocator's reserved bytes and
    waits for the word to exit."""
    import torch

    from repro_torch.kernels import _build

    a = torch.ones(256, 256, device="cuda")
    (a @ a).sum().item()
    _build.load("paged_attention")
    torch.cuda.synchronize()
    conn.send(torch.cuda.memory_reserved())
    conn.recv()


def cuda_context_bytes(timeout: float = 300.0) -> int:
    """Card memory one spawned worker holds outside its caching allocator:
    the card's used bytes while a probe process holds its context, cuBLAS
    and a kernel library, less the probe's reserved bytes.  The calling
    process must already hold a context of its own (its reading of the
    card's free memory does not count its own context's creation)."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    proc = ctx.Process(target=_context_probe, args=(child,), daemon=True)
    proc.start()
    try:
        if not parent.poll(timeout):
            raise TimeoutError("the context probe did not report")
        reserved = parent.recv()
        free1 = torch.cuda.mem_get_info()[0]
        parent.send(None)
    finally:
        proc.join(timeout)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout)
    if proc.exitcode != 0:
        raise RuntimeError(f"the context probe exited with {proc.exitcode}")
    return free0 - free1 - int(reserved)


class _StubEngine:
    """Deterministic engine double: token ``i`` of a prompt is
    ``(sum(prompt) + i) % 997``, with an optional per-token delay so
    tests can hold a replica busy.  Implements exactly the surface the
    worker loop drives (``generate``/``stats``/``export_pages``/
    ``import_pages``, the latter with the port's signature)."""

    def __init__(self, spec: "StubSpec", replica: int = 0):
        self.spec = spec
        self.replica = replica
        self._tokens = 0
        self._busy = 0

    def generate(self, prompts, max_new_tokens=16, on_token=None):
        max_new = max_new_tokens
        if isinstance(max_new, int):
            max_new = [max_new] * len(prompts)
        outs = []
        self._busy += 1
        try:
            for i, p in enumerate(prompts):
                base = int(sum(int(x) for x in np.asarray(p).reshape(-1)))
                toks = []
                for step in range(int(max_new[i])):
                    if self.spec.delay_s:
                        time.sleep(self.spec.delay_s)
                    t = (base + step) % 997
                    toks.append(t)
                    self._tokens += 1
                    if on_token is not None:
                        on_token(i, t)
                outs.append(toks)
        finally:
            self._busy -= 1
        return outs

    def stats(self) -> Dict[str, Any]:
        used = self._busy * self.spec.pages_per_request
        return {
            "batching": "paged",
            "free_pages": max(0, self.spec.pages_total - used),
            "used_pages": used,
            "pages_total": self.spec.pages_total,
            "slots_free": max(0, self.spec.slots_total - self._busy),
            "slots_total": self.spec.slots_total,
            "page_tokens": self.spec.page_tokens,
            "page_bytes": 0,
            "kv_shard": 1,
            "tokens": self._tokens,
            "decode_steps": self._tokens,
            "prefill_chunks": 0,
            "prefix_nodes": 0,
            "prefix_pages": 0,
            "prefix_resident_bytes": 0,
        }

    def export_pages(self, tokens):
        return None

    def import_pages(self, tokens, payloads, snaps=None):
        return 0


@dataclass(frozen=True)
class StubSpec:
    """Picklable factory for ``_StubEngine`` (protocol, HTTP and router
    tests: no model, deterministic tokens, controllable latency)."""

    pages_total: int = 64
    slots_total: int = 4
    page_tokens: int = 8
    pages_per_request: int = 8
    delay_s: float = 0.0

    def __call__(self, replica: int = 0) -> _StubEngine:
        return _StubEngine(self, replica)


# ---------------------------------------------------------------------------
# The worker loop (both transports run this, verbatim)
# ---------------------------------------------------------------------------


def _serve_loop(recv: Callable[[], Any], send: Callable[[Any], None],
                factory, replica: int, role: str) -> None:
    """Drain ``(seq, op, payload)`` instructions against one engine built
    at the first instruction.  Ops: ``generate`` (streams ``(seq, "token",
    (i, tok))`` before the final result), ``export`` / ``import``
    (disaggregation page hooks), ``stats``, ``trace``, ``shutdown``.  Any
    exception becomes a ``(seq, "err", msg)`` reply -- the worker never
    dies on a bad request.  After every instruction one unsolicited
    ``(_TICK, "stats", ReplicaStats)`` tick is pushed."""
    engine = None
    ticks = 0
    while True:
        seq, op, payload = recv()
        if op == "shutdown":
            send((seq, "ok", None))
            return
        send((seq, "begin", None))
        try:
            if engine is None:
                engine = factory(replica)
            if op == "generate":
                prompts, max_new = payload

                def cb(i, tok, _seq=seq):
                    send((_seq, "token", (i, tok)))

                result = engine.generate(prompts, max_new_tokens=max_new,
                                         on_token=cb)
            elif op == "export":
                result = engine.export_pages(payload)
            elif op == "import":
                tokens, payloads, snaps = payload
                result = engine.import_pages(tokens, payloads, snaps=snaps)
            elif op == "stats":
                result = engine.stats()
            elif op == "trace":
                tracer = getattr(engine, "tracer", None)
                result = (tracer.chrome_events(payload)
                          if tracer is not None else [])
            else:
                raise ValueError(f"unknown op {op!r}")
            send((seq, "ok", result))
        except Exception as e:                      # noqa: BLE001
            send((seq, "err", f"{type(e).__name__}: {e}"))
        ticks += 1
        if engine is not None:
            send((_TICK, "stats",
                  ReplicaStats.from_engine(engine, replica, role,
                                           ticks=ticks)))


def _proc_main(inq, outq, factory, replica: int, role: str) -> None:
    _serve_loop(inq.get, outq.put, factory, replica, role)


# ---------------------------------------------------------------------------
# Front side
# ---------------------------------------------------------------------------


class _Call:
    """One in-flight instruction: a future plus its streaming hooks."""

    def __init__(self, seq: int, op: str, payload: Any,
                 on_token=None, on_done=None):
        self.seq = seq
        self.op = op
        self.payload = payload
        self.on_token = on_token
        self.on_done = on_done
        self.t_submit = time.monotonic()
        self.first_token_time: Optional[float] = None
        self.started = False
        self.result: Any = None
        self.err: Optional[str] = None
        self._ev = threading.Event()

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = 60.0):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"call {self.op}#{self.seq} timed out")
        if self.err is not None:
            raise RuntimeError(self.err)
        return self.result

    def _finish(self, result=None, err=None) -> None:
        self.result = result
        self.err = err
        self._ev.set()
        if self.on_done is not None:
            _callback(self.on_done, self)


def _callback(fn, *args) -> None:
    """Run a caller's hook on the demux thread: a hook that raises is
    reported and the stream goes on (the demux serves every call)."""
    try:
        fn(*args)
    except Exception:                               # noqa: BLE001
        traceback.print_exc()


class Replica:
    """Front-side handle to one replica host.

    ``submit`` enqueues an instruction and returns a ``_Call``; a demux
    pump thread routes the shared response queue's messages back to their
    calls (token streams fire ``on_token(i, tok)`` as they arrive --
    ``tok is None`` is a stream reset after a recompute preemption).
    ``cancel_pending`` abandons instructions the worker has not begun
    (drain/requeue): the worker may still execute them later, but their
    replies are discarded -- wasted compute, never wrong results.  A
    spawned worker that exits fails every outstanding call."""

    def __init__(self, factory, replica: int = 0, role: str = "serve",
                 transport: str = "thread",
                 default_stats: Optional[ReplicaStats] = None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; "
                             f"one of {TRANSPORTS}")
        self.replica = replica
        self.role = role
        self.transport = transport
        self.engine = None              # thread transport: live telemetry
        self.last_stats: Optional[ReplicaStats] = None
        #: What a replica that has never served advertises -- the plan's
        #: pool geometry (whole pool free), so the ``free_pages`` policy
        #: spreads onto fresh replicas instead of starving them at the
        #: zero-telemetry default.
        self.default_stats = default_stats
        self._seq = 0
        self._calls: Dict[int, _Call] = {}
        self._lock = threading.Lock()
        self._closed = False
        if transport == "thread":
            self._inq: Any = queue.Queue()
            self._outq: Any = queue.Queue()

            def _build(rep):
                eng = factory(rep)
                self.engine = eng
                return eng

            self._worker: Any = threading.Thread(
                target=_serve_loop,
                args=(self._inq.get, self._outq.put, _build, replica, role),
                name=f"replica-{replica}", daemon=True)
        else:
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            self._inq = ctx.Queue()
            self._outq = ctx.Queue()
            self._worker = ctx.Process(
                target=_proc_main,
                args=(self._inq, self._outq, factory, replica, role),
                name=f"replica-{replica}", daemon=True)
        self._worker.start()
        self._pump = threading.Thread(target=self._demux,
                                      name=f"replica-{replica}-demux",
                                      daemon=True)
        self._pump.start()

    # ------------------------------------------------------------- demux
    def _demux(self) -> None:
        while True:
            try:
                msg = self._outq.get(timeout=0.1)
            except queue.Empty:
                if self._closed and not self._calls:
                    return
                if self.transport == "proc" and not self._worker.is_alive():
                    self._fail_all(f"replica {self.replica} worker exited "
                                   f"with code {self._worker.exitcode}")
                    if self._closed:
                        return
                continue
            except (EOFError, OSError):
                return
            seq, kind, payload = msg
            if seq == _TICK:
                self.last_stats = payload
                continue
            with self._lock:
                call = self._calls.get(seq)
            if call is None:
                continue                 # cancelled: discard the reply
            if kind == "begin":
                call.started = True
            elif kind == "token":
                i, tok = payload
                if tok is None:
                    call.first_token_time = None    # preempted: re-emits
                elif call.first_token_time is None:
                    call.first_token_time = time.monotonic()
                if call.on_token is not None:
                    _callback(call.on_token, i, tok)
            else:
                with self._lock:
                    self._calls.pop(seq, None)
                call._finish(result=payload if kind == "ok" else None,
                             err=payload if kind == "err" else None)

    def _fail_all(self, err: str) -> None:
        with self._lock:
            calls = list(self._calls.values())
            self._calls.clear()
        for call in calls:
            call._finish(err=err)

    # ----------------------------------------------------------- submits
    def submit(self, op: str, payload: Any, on_token=None,
               on_done=None) -> _Call:
        if self._closed:
            raise RuntimeError(f"replica {self.replica} is closed")
        with self._lock:
            seq = self._seq
            self._seq += 1
            call = _Call(seq, op, payload, on_token=on_token,
                         on_done=on_done)
            self._calls[seq] = call
        self._inq.put((seq, op, payload))
        return call

    def generate(self, prompts: Sequence[Any], max_new_tokens=16,
                 on_token=None, on_done=None) -> _Call:
        prompts = [np.asarray(p).tolist() if isinstance(p, np.ndarray)
                   else p for p in prompts]
        return self.submit("generate", (prompts, max_new_tokens),
                           on_token=on_token, on_done=on_done)

    # --------------------------------------------------------- telemetry
    def _load(self) -> Tuple[int, int]:
        with self._lock:
            gen = [c for c in self._calls.values() if c.op == "generate"]
        active = sum(1 for c in gen if c.started)
        return len(gen) - active, active

    def stats(self) -> ReplicaStats:
        """Latest telemetry, preferring the live engine (thread transport)
        so mid-generate pool pressure is visible; the spawn transport sees
        the last tick.  ``queued``/``active`` always come from this side's
        books."""
        st = None
        if self.engine is not None:
            try:
                st = ReplicaStats.from_engine(self.engine, self.replica,
                                              self.role)
            except RuntimeError:
                # The worker thread grew the registry while this read it:
                # the last tick stands in.
                st = None
        if st is None:
            base = self.last_stats or self.default_stats
            st = (replace(base) if base is not None
                  else ReplicaStats(replica=self.replica, role=self.role))
        st.replica = self.replica
        st.role = self.role
        st.queued, st.active = self._load()
        return st

    def trace(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """This replica's Chrome trace events (pid = replica id).  The
        thread transport reads the live tracer; the spawn transport
        round-trips a ``trace`` instruction.  Engines without a tracer
        (stubs) yield []."""
        if self.engine is not None:
            tracer = getattr(self.engine, "tracer", None)
            return tracer.chrome_events(last) if tracer is not None else []
        return self.submit("trace", last).wait() or []

    # -------------------------------------------------------------- drain
    def pending(self) -> List[_Call]:
        """Generate calls enqueued but not yet begun by the worker."""
        with self._lock:
            return [c for c in self._calls.values()
                    if c.op == "generate" and not c.started
                    and not c.done()]

    def cancel_pending(self) -> List[_Call]:
        """Abandon every not-yet-begun generate call (drain/requeue).
        Returns the abandoned calls so the router can resubmit their
        payloads elsewhere; late replies from this replica are ignored."""
        cancelled = []
        with self._lock:
            for seq, call in list(self._calls.items()):
                if call.op == "generate" and not call.started \
                        and not call.done():
                    del self._calls[seq]
                    cancelled.append(call)
        return cancelled

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker: a ``shutdown`` instruction after whatever is
        queued, a join, and for a spawned worker still alive after
        ``timeout``, a terminate.  The engine goes with the worker."""
        if self._closed:
            return
        self.submit("shutdown", None)
        self._closed = True
        self._worker.join(timeout)
        if self.transport == "proc" and self._worker.is_alive():
            self._worker.terminate()
            self._worker.join(timeout)
        self._pump.join(timeout)
        self.engine = None
