"""The serving steps (the port of ``repro.serve.steps``): plain callables
around the model's steps, run eagerly without autograd, on one card or
over a device mesh.

``make_serve_steps`` binds the cohort engine's prefill (into a cache of
``shape.seq_len + max_len_extra`` tokens) and decode step;
``make_paged_steps`` the paged engine's decode step, chunked prefill and
(enc_dec) admission-time encoder pass.

On a mesh (a ``DeviceMesh`` with axes ``("data", "model")``) the factories
make the reference's sharding decision.  Pass ``decode_plan`` (a
``HierarchicalPlan`` from ``serve.engine.plan_decode``) and the plan's
mesh-level KV head sharding is realised through
``dist.sharding.with_kv_sharding``: the cache's (and the pool's) head dim
shards over "model" exactly when the plan's ``kv_shard > 1`` and the KV
heads divide the axis.  Without a plan the ``cache_policy`` heuristics
apply: "auto" shards the cache over heads when they divide the model
axis, else over the sequence for decode; "baseline" takes the
``cache_head_sharded``/``cache_seq_sharded`` flags as given.

The parameters are DTensors with ``param_sharding``'s placements
(``place_params``); the cache's leaves are DTensors placed by their
logical axes (``launch.specs.cache_logical_axes``, whose PartitionSpecs
the cohort steps' ``cache_sharding`` holds, or
``serve.pages.paged_cache_logical_axes`` for the pool), less any mesh
axis a dim does not divide; the host counters (``len``, ``pos``) and the
page table stay plain tensors, the same on every rank.  Each step runs
under ``use_mesh_rules`` and DTensor's ``implicit_replication`` (plain
index tensors count as replicated), takes its batch as plain tensors
(the same on every rank) and returns its logits gathered whole, so the
engine samples the same tokens on every rank.  Off a mesh the steps are
the one-card ones (autograd off, nothing else) and the sharding fields
are None.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (
    ShardingRules,
    arch_rules,
    logical_sharding,
    param_shardings,
    use_mesh_rules,
    with_batch_guard,
    with_kv_sharding,
)
from repro_torch.launch.specs import (
    batch_logical_axes,
    cache_logical_axes,
    decode_footprint,
)
from repro_torch.models.model import Model
from repro_torch.tree import tree_map

PyTree = Any

#: Cache leaves that are host counters or host-built indices: never
#: placed on the mesh.
HOST_LEAVES = ("len", "pos", "table")


@dataclass
class _MeshPlacer:
    """Placement of a step's inputs on its mesh: parameters by their
    placements tree, batch and cache leaves by their logical axes."""

    mesh: Any
    rules: ShardingRules
    param_sharding: PyTree
    cache_axes: Callable[[PyTree], PyTree]

    def params(self, params: PyTree) -> PyTree:
        from repro_torch.launch.trainer import distribute

        def place(t, pl):
            if isinstance(t, DTensor):
                return t if tuple(t.placements) == tuple(pl) else \
                    t.redistribute(self.mesh, pl)
            return distribute(t, self.mesh, pl)

        return _zip_map(place, params, self.param_sharding)

    def act(self, t: torch.Tensor, axes) -> torch.Tensor:
        from repro_torch.launch.trainer import distribute

        if isinstance(t, DTensor):
            return t
        pl = logical_sharding(self.mesh, self.rules, axes, tuple(t.shape),
                              kind="act")
        return distribute(t, self.mesh, pl)

    def batch(self, batch: dict, axes: dict) -> dict:
        return {k: self.act(v, axes[k]) if k in axes
                and isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}

    def cache(self, cache: PyTree) -> PyTree:
        axes = self.cache_axes(cache)

        def walk(node, ax, name=""):
            if isinstance(node, dict):
                return {k: walk(v, ax[k], k) for k, v in node.items()}
            if name in HOST_LEAVES or not isinstance(node, torch.Tensor):
                return node
            return self.act(node, ax)

        return walk(cache, axes)


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over a dict tree and a tree of the same
    keys (its leaves may be tuples, as placements are)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def full_tensor(t):
    """A step output as a plain tensor (a DTensor gathered whole)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _spec_tree(rules: ShardingRules, axes: PyTree) -> PyTree:
    """The PartitionSpec tree of a logical-axes tree."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return rules.act_spec(node)
    return walk(axes)


def _mesh_size(sizes: dict) -> int:
    n = 1
    for v in sizes.values():
        n *= v
    return n


@contextlib.contextmanager
def _mesh_scope(mesh, rules):
    """The context a mesh step runs in: no autograd, the rules, and
    DTensor's implicit replication of plain tensors."""
    with torch.no_grad(), use_mesh_rules(mesh, rules), \
            implicit_replication():
        yield


@dataclass
class ServeSteps:
    """``prefill(params, batch)`` -> ``(logits, cache)`` with a cache of
    the bound capacity (``Model.prefill``), and ``decode(params, cache,
    batch)`` -> ``(logits, cache)`` (``Model.decode_step``).  On a mesh,
    ``param_sharding`` is the parameters' placements tree and
    ``cache_sharding`` the cache's PartitionSpec tree; ``place_params``
    and ``place_cache`` put a tree of plain tensors on the mesh (the
    identity off one)."""

    prefill: Callable
    decode: Callable
    model: Model
    param_sharding: PyTree = None
    cache_sharding: PyTree = None
    place_params: Callable = lambda p: p
    place_cache: Callable = lambda c: c


def make_serve_steps(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh=None,
    dtype=torch.bfloat16,
    max_len_extra: int = 0,
    cache_head_sharded: bool = False,
    cache_seq_sharded: bool = False,
    cache_policy: str = "auto",
    decode_plan: Optional[Any] = None,
) -> ServeSteps:
    """The cohort steps for ``shape`` (``global_batch`` rows of
    ``seq_len``-token prompts into a cache of ``seq_len + max_len_extra``
    tokens).

    ``cache_policy="auto"`` shards the KV cache over heads when the KV
    heads divide the model axis (attention stays shard-local), else over
    the sequence dim for decode (grouped-GQA decode); explicit
    ``cache_head_sharded``/``cache_seq_sharded`` flags override it
    (``cache_policy="baseline"`` takes them alone).  ``decode_plan``
    overrides all of it with the planner's choice (``cache_policy``
    becomes "plan")."""
    max_len = shape.seq_len + max_len_extra
    model = Model(cfg)
    if mesh is None:
        def prefill(params: PyTree, batch):
            with torch.no_grad():
                return model.prefill(params, batch, max_len, dtype=dtype)

        def decode(params: PyTree, cache: PyTree, batch):
            with torch.no_grad():
                return model.decode_step(params, cache, batch, dtype=dtype)

        return ServeSteps(prefill=prefill, decode=decode, model=model)

    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    model_size = sizes.get("model", 1)
    heads_divide = cfg.n_kv_heads % model_size == 0
    seq_divides = max_len % model_size == 0
    kv_shard = 0
    if decode_plan is not None:
        kv_shard = decode_plan.kv_shard()
        cache_head_sharded = kv_shard > 1 and heads_divide
        cache_seq_sharded = False
        cache_policy = "plan"
    if cache_policy == "auto" and not (cache_head_sharded
                                       or cache_seq_sharded):
        if not heads_divide and seq_divides and shape.kind == "decode":
            cache_seq_sharded = True
        elif heads_divide:
            cache_head_sharded = True
    long_context = shape.seq_len >= 262144 or cache_seq_sharded
    if cache_head_sharded and heads_divide:
        # Head sharding: attention local per head shard, no distributed
        # softmax; preferred whenever the head count divides the axis.
        long_context = False
    # Serving memory model: bf16 weights only (no master copy or moments),
    # the KV cache as the reserved term, divided by the whole mesh (it
    # shards over batch and heads).
    rules = arch_rules(
        cfg, mesh, seq_sharded=long_context, state_bytes_per_param=2,
        act_bytes=decode_footprint(cfg, shape, max_len) // _mesh_size(sizes))
    rules = with_batch_guard(rules, mesh, shape.global_batch)
    if decode_plan is not None:
        rules = with_kv_sharding(rules, kv_shard if cache_head_sharded
                                 else 1)
    p_shard = param_shardings(mesh, rules, model.param_specs())
    tpl = model.init_cache(shape.global_batch, max_len, dtype,
                           enc_len=shape.seq_len, device="meta")
    c_shard = _spec_tree(rules, cache_logical_axes(cfg, tpl, long_context))
    placer = _MeshPlacer(mesh, rules, p_shard, lambda c: cache_logical_axes(
        cfg, c, long_context))
    d_axes = batch_logical_axes(cfg, "decode")
    t_axes = {k: v for k, v in batch_logical_axes(cfg, "train").items()
              if k != "labels"}

    def prefill(params: PyTree, batch, then: Optional[Callable] = None):
        # ``then`` is applied to the fresh cache after its placement (the
        # dry run swaps the host counters for host integers there).
        place = placer.cache if then is None else \
            (lambda c: then(placer.cache(c)))
        with _mesh_scope(mesh, rules):
            logits, cache = model.prefill(params, placer.batch(batch, t_axes),
                                          max_len, dtype=dtype, place=place)
            return full_tensor(logits), cache

    def decode(params: PyTree, cache: PyTree, batch):
        with _mesh_scope(mesh, rules):
            logits, cache = model.decode_step(
                params, cache, placer.batch(batch, d_axes), dtype=dtype)
            return full_tensor(logits), cache

    return ServeSteps(prefill=prefill, decode=decode, model=model,
                      param_sharding=p_shard, cache_sharding=c_shard,
                      place_params=placer.params, place_cache=placer.cache)


@dataclass
class PagedServeSteps:
    """``decode(params, cache, batch)`` and ``prefill_chunk(params, cache,
    tokens, pos0, slot)``, each returning ``(logits, cache)``; for enc_dec,
    ``encode(params, enc_embeds)`` returning the request's cross K/V
    (``Model.encode_cross``), else None.  ``param_sharding`` and the
    placers are ``ServeSteps``'; the pool is placed by its own shapes
    (``place_cache``), so there is no cache sharding to fix in advance."""

    decode: Callable
    prefill_chunk: Callable
    model: Model
    encode: Optional[Callable] = None
    param_sharding: PyTree = None
    place_params: Callable = lambda p: p
    place_cache: Callable = lambda c: c


def make_paged_steps(
    cfg: ModelConfig,
    mesh=None,
    n_slots: int = 1,
    max_len: int = 4096,
    dtype=torch.bfloat16,
    decode_plan: Optional[Any] = None,
) -> PagedServeSteps:
    """The paged engine's steps (``Model.decode_step_paged``,
    ``Model.prefill_chunk``, ``Model.encode_cross``) in ``dtype``.

    On a mesh the plan's KV head sharding applies to the pool as it does
    to the dense cache -- ``with_kv_sharding`` maps the pool's "kv_heads"
    axis and pins the page dim ("kv_pages") unsharded, since a page is the
    shared-memory streaming granule of ONE card; the slots' batch shards
    over the data axes where ``n_slots`` divides them."""
    model = Model(cfg)
    if mesh is None:
        def decode(params: PyTree, cache: PyTree, batch):
            with torch.no_grad():
                return model.decode_step_paged(params, cache, batch,
                                               dtype=dtype)

        def prefill_chunk(params: PyTree, cache: PyTree, tokens, pos0, slot):
            with torch.no_grad():
                return model.prefill_chunk(
                    params, cache, {"tokens": tokens, "pos0": pos0,
                                    "slot": slot}, dtype=dtype)

        encode = None
        if cfg.family == "enc_dec":
            def encode(params: PyTree, enc_embeds):
                with torch.no_grad():
                    return model.encode_cross(
                        params, {"enc_embeds": enc_embeds}, dtype=dtype)

        return PagedServeSteps(decode=decode, prefill_chunk=prefill_chunk,
                               model=model, encode=encode)

    from repro_torch.serve.pages import paged_cache_logical_axes

    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    # The pool's KV heads: mla_moe's latent pool holds one (its R + dr
    # row), whatever ``n_kv_heads`` says, and a dim of one never shards.
    pool_kv = 1 if cfg.family == "mla_moe" else cfg.n_kv_heads
    heads_divide = pool_kv % sizes.get("model", 1) == 0
    kv_shard = decode_plan.kv_shard() if decode_plan is not None else 1
    shape = ShapeConfig("paged", 1, n_slots, "decode")
    rules = arch_rules(
        cfg, mesh, state_bytes_per_param=2,
        act_bytes=decode_footprint(cfg, shape, max_len) // _mesh_size(sizes))
    rules = with_batch_guard(rules, mesh, n_slots)
    rules = with_kv_sharding(rules, kv_shard if heads_divide else 1)
    p_shard = param_shardings(mesh, rules, model.param_specs())
    placer = _MeshPlacer(mesh, rules, p_shard,
                         lambda c: paged_cache_logical_axes(cfg, c))
    d_axes = batch_logical_axes(cfg, "decode")

    def decode(params: PyTree, cache: PyTree, batch):
        with _mesh_scope(mesh, rules):
            logits, cache = model.decode_step_paged(
                params, cache, placer.batch(batch, d_axes), dtype=dtype)
            return full_tensor(logits), cache

    def prefill_chunk(params: PyTree, cache: PyTree, tokens, pos0, slot):
        # The chunk's tokens are replicated (one slot's prompt).
        with _mesh_scope(mesh, rules):
            logits, cache = model.prefill_chunk(
                params, cache, {"tokens": tokens, "pos0": pos0,
                                "slot": slot}, dtype=dtype)
            return full_tensor(logits), cache

    encode = None
    if cfg.family == "enc_dec":
        def encode(params: PyTree, enc_embeds):
            with _mesh_scope(mesh, rules):
                return tree_map(full_tensor, model.encode_cross(
                    params, {"enc_embeds": enc_embeds}, dtype=dtype))

    return PagedServeSteps(decode=decode, prefill_chunk=prefill_chunk,
                           model=model, encode=encode,
                           param_sharding=p_shard,
                           place_params=placer.params,
                           place_cache=placer.cache)
