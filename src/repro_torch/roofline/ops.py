"""Op-level analysis of an eager step: the port's counterpart of
``repro.roofline.hlo`` (which reads a compiled XLA module's HLO text).

An eager PyTorch step has no HLO.  ``analyze_ops(fn, *args)`` runs it once
under a ``TorchDispatchMode`` that sees every ATen op the step runs on
plain tensors -- on a mesh, the LOCAL shards: an op on DTensors is handed
back (``NotImplemented``) to DTensor, which runs it as local ops and
collectives that the mode then sees.  So every op is counted once, at its
local size, which is what the reference's per-device HLO counts (torch's
``FlopCounterMode`` over DTensors counts the DTensor-level ops at their
global sizes and the regions run on local shards at their local ones).  It
works under ``FakeTensorMode`` (no storage) and on real tensors alike.

Three quantities, per rank, as ``OpSummary``:

  * FLOPs of the matmul, convolution and attention ops (torch's own flop
    formulas, ``torch.utils.flop_counter``, on the local shapes);
  * HBM bytes: operand plus output bytes of every op -- eager has no
    fusion, so every op boundary is an HBM round trip.  Views cost
    nothing.  An in-place update (``copy_`` into a view, ``index_put_``,
    ``index_copy_``, ...) costs its sources plus the written region, never
    the whole destination: the reference's dynamic-update-slice rule;
  * collective bytes by the reference's five names, the operand bytes of
    each collective the program asks for: ``all_gather_into_tensor`` an
    all-gather, ``all_reduce`` an all-reduce, ``reduce_scatter_tensor`` a
    reduce-scatter, ``all_to_all_single`` (and DTensor's
    ``shard_dim_alltoall``) an all-to-all -- booked as such even where the
    CPU backend falls back to an all-gather -- and the rings' P2P sends a
    collective-permute (``dist.overlap`` books them through
    ``book_collective``: P2P is not a dispatcher op).

Eager execution runs every trip of every loop.  Where a step's loops run
too many trips to trace whole (the dry run's long prefills: blockwise
attention's block pairs, the xLSTM's tokens and chunks), the dry run turns
on ``sampling_loops``: each loop run through ``loop`` then runs its first,
second and last trips, the second counted -- forward and backward -- for
every middle one (the counterpart of the reference's ``loop_trip_counts``,
which multiplies a ``lax.scan`` body traced once).
"""

from __future__ import annotations

import contextlib
import threading
from functools import partial
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: The reference's collective names (``repro.roofline.hlo.COLLECTIVES``).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: Dispatcher collectives (functional and c10d forms) by the name they are
#: booked under.
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

#: In-place updates whose cost is the sources plus the written region:
#: ``(op name, index of the source whose size is the written region)``.
_UPDATES = {"copy_": 1, "index_put_": 2, "index_copy_": 3, "index_add_": 3,
            "index_fill_": None, "masked_fill_": None, "scatter_": 3,
            "scatter_add_": 3, "slice_scatter": 1, "select_scatter": 1}

#: Ops that move no data a device would (metadata, waits, RNG state).
_FREE = {"wait_tensor", "detach", "_to_copy_meta", "lift_fresh",
         "alias", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "empty", "empty_strided", "empty_like"}


@dataclass
class OpSummary:
    """``HLOSummary``'s fields for an eager step: per-rank ``flops``,
    ``hbm_bytes``, ``collective_bytes`` keyed by the five collective
    names, and ``n_collective_ops``; ``collectives`` records each
    dispatcher collective as ``(name, operand shapes)``, and
    ``collective_result_bytes`` the bytes each hands back to the rank (an
    all-gather's gathered tensor, the group size times its operand)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_result_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    collectives: List[Tuple[str, List[Tuple[int, ...]]]] = field(
        default_factory=list)
    n_collective_ops: int = 0
    n_ops: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    if isinstance(x, dict):
        return [t for a in x.values() for t in _tensors(a)]
    return []


_ACTIVE = threading.local()


def book_collective(kind: str, nbytes: int) -> None:
    """Book ``nbytes`` of a collective the program asked for outside the
    dispatcher (the rings' P2P sends: "collective-permute") with the
    analysis running in this thread, as many bytes handed back as sent;
    a no-op without one."""
    counter = getattr(_ACTIVE, "counter", None)
    if counter is not None and not counter.suppress:
        counter.summary.collective_bytes[kind] += counter.weight * nbytes
        counter.summary.collective_result_bytes[kind] += \
            counter.weight * nbytes
        counter.summary.n_collective_ops += 1


@contextlib.contextmanager
def counted_as(n: float):
    """Count every op of the block ``n`` times (nested blocks multiply);
    a no-op without an analysis running in this thread."""
    counter = getattr(_ACTIVE, "counter", None)
    if counter is None:
        yield
        return
    prev = counter.weight
    counter.weight = prev * n
    try:
        yield
    finally:
        counter.weight = prev


@contextlib.contextmanager
def _uncounted():
    counter = getattr(_ACTIVE, "counter", None)
    if counter is not None:
        counter.suppress += 1
    try:
        yield
    finally:
        if counter is not None:
            counter.suppress -= 1


@contextlib.contextmanager
def sampling_loops(on: bool = True):
    """Within the block (and this thread), loops run through ``loop`` run
    three trips -- the first, the second counted for every middle one,
    and the last -- where they have more.  Only for counting: the
    skipped trips' outputs keep their shapes, not their values."""
    prev = getattr(_ACTIVE, "sampling", False)
    _ACTIVE.sampling = bool(on)
    try:
        yield
    finally:
        _ACTIVE.sampling = prev


class _SampledTrip(torch.autograd.Function):
    """``fn(*args)`` -- one middle trip of a loop -- run once and counted
    ``n`` times, forward and backward, with ``n - 1`` more accumulations
    of each ``shared`` argument's gradient (``n`` trips add up their
    gradients of an argument every trip reads whole).  The backward
    recomputes the trip uncounted, as a checkpoint does."""

    @staticmethod
    def forward(ctx, fn, n, shared, *args):
        ctx.fn, ctx.n, ctx.shared = fn, n, shared
        ctx.save_for_backward(*args)
        with counted_as(n):
            return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(a.requires_grad)
                   for a in ctx.saved_tensors]
            with _uncounted():
                outs = ctx.fn(*ins)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            want = [i for i in ins if i.requires_grad]
            with counted_as(ctx.n):
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], want, [g for _, g in pairs],
                    allow_unused=True))
        out = [next(got) if i.requires_grad else None for i in ins]
        with counted_as(ctx.n - 1):
            for j in ctx.shared:
                if out[j] is not None:
                    out[j] + out[j]
        return (None, None, None) + tuple(out)


def loop(n: int, step, shared: tuple, carry: tuple):
    """``for t in range(n): y, *carry = step(t, *shared, *carry)``:
    returns ``([y_0, ..., y_{n-1}], carry)``.  ``shared`` are the
    tensors every trip reads whole (slicing its own part), ``carry`` what
    each trip hands the next.  Under ``sampling_loops`` a loop of more
    than three trips runs the first, the second and the last: the second
    stands for all the middle ones, its ops -- forward and backward --
    counted ``n - 2`` times (``_SampledTrip``), and its ``y`` repeated
    for theirs."""
    sample = getattr(_ACTIVE, "sampling", False) and n > 3
    trips = [(0, 1), (1, n - 2), (n - 1, 1)] if sample else \
        [(t, 1) for t in range(n)]
    ys = []
    for t, w in trips:
        args = tuple(shared) + tuple(carry)
        if w > 1 and torch.is_grad_enabled() and any(
                a.requires_grad for a in args):
            out = _SampledTrip.apply(partial(step, t), w,
                                     tuple(range(len(shared))), *args)
        else:
            with counted_as(w):
                out = step(t, *args)
        if out[0] is not None:
            ys += [out[0]] + [out[0].detach()] * (w - 1)
        carry = tuple(out[1:])
    return ys, carry


class _OpCounter(TorchDispatchMode):
    """The counting mode: DTensor ops are handed back to DTensor, whose
    local ops and collectives come back here as plain-tensor ops."""

    def __init__(self):
        super().__init__()
        self.summary = OpSummary()
        self.weight = 1.0
        self.suppress = 0
        self.propagating = 0
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.suppress:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        s, wt = self.summary, self.weight
        name = func._overloadpacket.__name__
        s.n_ops += 1
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            ins = _tensors(args[:1])
            s.collective_bytes[kind] += wt * sum(_nbytes(t) for t in ins)
            s.collective_result_bytes[kind] += wt * sum(
                _nbytes(t) for t in _tensors(out))
            s.n_collective_ops += 1
            s.collectives.append((kind, [tuple(t.shape) for t in ins]))
            return
        f = self._flops.get(func._overloadpacket)
        if f is not None:
            n = wt * float(f(*args, **kwargs, out_val=out))
            s.flops += n
            s.flops_by_op[name] = s.flops_by_op.get(name, 0.0) + n
        if name in _FREE or func.is_view or func.namespace == "prim":
            return                      # prim ops read metadata only
        if name in _UPDATES:
            src = _UPDATES[name]
            others = [t for i, a in enumerate(args) if i != 0
                      for t in _tensors(a)]
            region = (_nbytes(args[src]) if src is not None
                      and src < len(args) and isinstance(args[src],
                                                         torch.Tensor)
                      else _nbytes(args[0]))
            if name == "copy_":
                region = args[0].numel() * args[0].element_size()
            s.hbm_bytes += wt * (sum(_nbytes(t) for t in others) + region)
            return
        ins = _tensors(args) + _tensors(kwargs)
        s.hbm_bytes += wt * (sum(_nbytes(t) for t in ins)
                             + sum(_nbytes(t) for t in _tensors(out)))


@contextlib.contextmanager
def _patched(owner, name: str, make):
    """``owner.name`` replaced by ``make(original)`` for the block (left
    alone where this torch has no such attribute)."""
    orig = getattr(owner, name, None)
    if orig is None:
        yield
        return
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def _as_requested(counter: _OpCounter):
    """Two DTensor internals, seen as the program asks for them: its
    shard-dim all-to-all is booked as one, also where a CPU mesh falls
    back to all-gather + chunk (the all-gather is not booked); and its
    sharding propagation, which runs each new op once on fake GLOBAL
    tensors to learn the output's shape, is not counted at all."""
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def quiet(orig, book=None, propagation=False):
        def wrapped(*a, **k):
            if book is not None:
                book(*a)
            counter.suppress += 1
            counter.propagating += propagation
            try:
                return orig(*a, **k)
            finally:
                counter.suppress -= 1
                counter.propagating -= propagation
        return wrapped

    with _patched(pt, "shard_dim_alltoall", lambda o: quiet(
            o, lambda inp, *_: book_collective("all-to-all", _nbytes(inp)))), \
            _patched(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                     lambda o: quiet(o, propagation=True)):
        yield


def propagating() -> bool:
    """Whether the analysis running in this thread is inside DTensor's
    sharding propagation (fake global tensors no rank holds: a memory
    tracker skips them too)."""
    counter = getattr(_ACTIVE, "counter", None)
    return counter is not None and counter.propagating > 0


def analyze_ops(fn: Callable, *args, **kwargs) -> OpSummary:
    """Run ``fn(*args, **kwargs)`` once and count its ops (see the module
    docstring); returns the per-rank ``OpSummary``.  The result of ``fn``
    is dropped."""
    counter, _ = analyze_ops_with_result(fn, *args, **kwargs)
    return counter


def analyze_ops_with_result(fn: Callable, *args, **kwargs
                            ) -> Tuple[OpSummary, Any]:
    """``analyze_ops`` that also returns ``fn``'s result."""
    counter = _OpCounter()
    prev = getattr(_ACTIVE, "counter", None)
    _ACTIVE.counter = counter
    try:
        with _as_requested(counter), counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.counter = prev
    return counter.summary, out
