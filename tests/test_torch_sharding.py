"""The port's sharding rules and the planner's mesh level
(``repro_torch.dist.sharding``, ``repro_torch.core.plan``) against the JAX
package's, at plan level: no process group, no tensor.

Both packages get one hierarchy: ``h100_hierarchy(mesh_devices=N)`` (or a
shrunk HBM), carried into the reference through the JSON schema with its
level names (``ICI`` for the port's ``NVLINK``, ``VREG`` for ``REG``).
The port reads meshes as an ``AbstractMesh``; the reference as
``jax.sharding.AbstractMesh((sizes), (names))``, which jax 0.9.0 accepts.
Held equal: ``mesh_decomposition``, ``mesh_plan``'s NVLINK/ICI node,
``default_rules`` and ``arch_rules`` for every registered arch on (4, 4),
(2, 4), (1, 4) and (8, 1) meshes (tables and the decomposer's meta), the
replicated -> FSDP flip under a shrunk HBM, ``with_batch_guard``,
``with_kv_sharding``, ``resolve_collectives`` ("auto" included),
``_divisible_spec``, and ``PlanPolicy.max_np`` and the horizontal strategy
at the mesh and tile levels.  The DTensor placements of a spec are checked
by hand.
"""

import dataclasses

import pytest
from jax.sharding import AbstractMesh as RefMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_model_config as ref_config
from repro.core import plan as ref_plan
from repro.core.hierarchy import MemoryLevel as RefLevel
from repro.dist import sharding as ref_sh
from repro_torch.configs import get_model_config, list_archs
from repro_torch.core import plan as my_plan
from repro_torch.dist import sharding as my_sh
from repro_torch.hw.h100 import h100_spec

MESHES = [(4, 4), (2, 4), (1, 4), (8, 1)]
ARCHS = list_archs()
_REF_NAMES = {"NVLINK": "ICI", "REG": "VREG"}


def _as_reference(tree):
    d = tree.to_dict()
    node = d
    while node is not None:
        node["name"] = _REF_NAMES.get(node["name"], node["name"])
        node = node["child"]
    return RefLevel.from_dict(d)


def _meshes(shape, names=("data", "model")):
    return my_sh.AbstractMesh(shape, names), RefMesh(shape, names)


def _hier(shape, hbm=None):
    n = shape[0] * shape[1]
    spec = h100_spec(hbm_bytes=hbm) if hbm else h100_spec()
    h = spec.hierarchy(mesh_devices=n)
    return h, _as_reference(h)


def _configs(arch):
    mine = get_model_config(arch)
    ref = dataclasses.replace(ref_config(arch), overhead=mine.overhead)
    return mine, ref


def _same_rules(mine, ref):
    assert mine.param_rules == ref.param_rules
    assert mine.act_rules == ref.act_rules
    for k in ("mesh_np", "fsdp_degree", "mesh_budget_bytes", "mesh_fits",
              "fsdp", "fsdp_capacity", "dcn_np"):
        assert mine.meta[k] == ref.meta[k], k


def test_mesh_hierarchy_spans_the_cards():
    h = h100_spec().hierarchy(mesh_devices=8)
    assert h.name == "NVLINK" and h.size == 8 * h.child.size
    assert h.child.siblings == [[c] for c in range(8)]
    # The default stays one card a host: no plan of the earlier slices moves.
    one = h100_spec().hierarchy()
    assert one.size == one.child.size and one.child.siblings == [[0]]
    two = h100_spec().hierarchy(mesh_devices=4, hosts=2)
    assert two.name == "DCN" and two.child.siblings == [[0, 1, 2, 3],
                                                        [4, 5, 6, 7]]
    mesh = my_sh.AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    h = my_sh.mesh_hierarchy(mesh)
    assert h.name == "DCN" and len(h.child.siblings) == 2
    assert h.child.size == 16 * h100_spec().hbm_bytes


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("gib", [1, 16, 200])
def test_mesh_decomposition_matches_reference(shape, gib):
    h, r = _hier(shape, hbm=8 << 30)
    for rep in (0, 1 << 30):
        mine = my_sh.mesh_decomposition(h, gib << 30, rep)
        ref = ref_sh.mesh_decomposition(r, gib << 30, rep)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.replicated == ref.replicated


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_plan_matches_reference(shape):
    mesh, rmesh = _meshes(shape)
    h, r = _hier(shape, hbm=4 << 30)
    for state in (1 << 28, 10 << 30, 100 << 30):
        for cap in (None, 2, shape[0]):
            mine = my_sh.mesh_plan(mesh, state_bytes=state, act_bytes=1 << 29,
                                   hierarchy=h, max_np=cap, overhead=1.25)
            ref = ref_sh.mesh_plan(rmesh, state_bytes=state,
                                   act_bytes=1 << 29, hierarchy=r,
                                   max_np=cap, overhead=1.25)
            a, b = mine.level("NVLINK"), ref.level("ICI")
            for f in ("np_raw", "np", "extent", "fits", "budget_bytes",
                      "granule_bytes", "partition_bytes"):
                assert getattr(a, f) == getattr(b, f), (state, cap, f)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_arch_rules_match_reference(arch, shape):
    mesh, rmesh = _meshes(shape)
    h, r = _hier(shape)
    mine_cfg, ref_cfg = _configs(arch)
    for seq in (False, True):
        _same_rules(my_sh.arch_rules(mine_cfg, mesh, seq_sharded=seq,
                                     hierarchy=h, act_bytes=1 << 30),
                    ref_sh.arch_rules(ref_cfg, rmesh, seq_sharded=seq,
                                      hierarchy=r, act_bytes=1 << 30))


@pytest.mark.parametrize("shape", MESHES)
def test_default_rules_match_reference(shape):
    mesh, rmesh = _meshes(shape)
    h, r = _hier(shape)
    for state in (0, 40 << 30, 4000 << 30):
        _same_rules(my_sh.default_rules(mesh, state_bytes=state, hierarchy=h),
                    ref_sh.default_rules(rmesh, state_bytes=state,
                                         hierarchy=r))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_shrunk_hbm_flips_replicated_to_fsdp(arch):
    mesh, rmesh = _meshes((4, 4))
    mine_cfg, ref_cfg = _configs(arch)
    big, rbig = _hier((4, 4))
    small, rsmall = _hier((4, 4), hbm=(mine_cfg.param_count() * 14 // 4)
                          // 3)
    roomy = my_sh.arch_rules(mine_cfg, mesh, hierarchy=big)
    tight = my_sh.arch_rules(mine_cfg, mesh, hierarchy=small)
    if arch == "llama3.2-1b":
        assert not roomy.meta["fsdp"] and roomy.param_rules["embed"] is None
    assert tight.meta["fsdp"] and tight.param_rules["embed"] == "data"
    _same_rules(roomy, ref_sh.arch_rules(ref_cfg, rmesh, hierarchy=rbig))
    _same_rules(tight, ref_sh.arch_rules(ref_cfg, rmesh, hierarchy=rsmall))
    # "auto" takes the serpentine rings exactly when the planner chose FSDP.
    for rules in (roomy, tight):
        got = my_sh.resolve_collectives(rules, "auto")
        want = "serpentine" if rules.meta["fsdp"] else None
        assert got.meta.get("collectives") == want


@pytest.mark.parametrize("mode", ["gspmd", "ring", "serpentine", "auto"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_resolve_collectives_matches_reference(mode, fsdp):
    mine = my_sh.ShardingRules({}, {"batch": "data"}, meta={"fsdp": fsdp})
    ref = ref_sh.ShardingRules({}, {"batch": "data"}, meta={"fsdp": fsdp})
    a = my_sh.resolve_collectives(mine, mode)
    b = ref_sh.resolve_collectives(ref, mode)
    assert a.meta == b.meta
    with pytest.raises(ValueError, match="unknown collectives"):
        my_sh.with_collectives(mine, "bogus")


@pytest.mark.parametrize("shape", [(4, 4), (2, 4), (8, 1), (3, 2)])
@pytest.mark.parametrize("batch", [1, 2, 6, 8, 12, 16])
def test_with_batch_guard_matches_reference(shape, batch):
    names = ("pod", "data") if shape == (3, 2) else ("data", "model")
    mesh, rmesh = _meshes(shape, names)
    table = {"batch": names if shape == (3, 2) else "data"}
    a = my_sh.with_batch_guard(my_sh.ShardingRules({}, dict(table)), mesh,
                               batch)
    b = ref_sh.with_batch_guard(ref_sh.ShardingRules({}, dict(table)), rmesh,
                                batch)
    assert a.act_rules == b.act_rules


@pytest.mark.parametrize("kv_shard", [1, 4])
def test_with_kv_sharding_matches_reference(kv_shard):
    mesh, rmesh = _meshes((2, 4))
    cfg, rcfg = _configs("llama3.2-1b")
    a = my_sh.with_kv_sharding(my_sh.arch_rules(cfg, mesh), kv_shard)
    b = ref_sh.with_kv_sharding(ref_sh.arch_rules(rcfg, rmesh), kv_shard)
    assert a.act_rules == b.act_rules
    assert a.meta["kv_shard"] == b.meta["kv_shard"] == kv_shard


@pytest.mark.parametrize("spec,shape", [
    ((("data", "model"), None), (16, 3)),
    ((("data", "model"), None), (8, 3)),
    ((("data", "model"), None), (6, 3)),
    (("model", "data"), (4, 6)),
    ((None, "model", "data"), (5, 2, 4)),
])
def test_divisible_spec_matches_reference(spec, shape):
    sizes = {"data": 2, "model": 4}
    from jax.sharding import PartitionSpec as RefP
    a = my_sh._divisible_spec(my_sh.P(*spec), shape, sizes)
    b = ref_sh._divisible_spec(RefP(*spec), shape, sizes)
    assert tuple(a) == tuple(b)


def test_placements_follow_the_spec():
    mesh = my_sh.AbstractMesh((2, 4), ("data", "model"))
    P = my_sh.P
    assert my_sh.placements(mesh, P(None, "model")) == (Replicate(), Shard(1))
    assert my_sh.placements(mesh, P("data", "model")) == (Shard(0), Shard(1))
    assert my_sh.placements(mesh, P(("data", "model"), None)) == \
        (Shard(0), Shard(0))
    assert my_sh.placements(mesh, P(None, None)) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        my_sh.placements(mesh, P(("model", "data")))
    cfg = get_model_config("llama3.2-1b").reduced()
    rules = my_sh.arch_rules(cfg, mesh)
    from repro_torch.models.model import Model
    tree = my_sh.param_shardings(mesh, rules, Model(cfg).param_specs())
    assert tree["layers"]["attn"]["wq"] == (Replicate(), Shard(2))
    assert tree["layers"]["attn"]["wo"] == (Replicate(), Shard(1))
    assert tree["embedding"] == (Replicate(), Shard(0))
    # 2 KV heads x 16 = 32 columns divide a 4-way axis: sharded by column.
    assert tree["layers"]["attn"]["wk"] == (Replicate(), Shard(2))


@pytest.mark.parametrize("cap", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy", ["cache_conscious", "horizontal"])
def test_max_np_and_horizontal_at_the_mesh_level(cap, strategy):
    h, r = _hier((2, 4), hbm=2 << 30)
    for state in (1 << 30, 6 << 30, 40 << 30):
        for workers in (1, 2, 4):
            w = dict(state_bytes=state, replicated_bytes=1 << 28)
            a = my_plan.plan_run(h, my_plan.Workload(**w), my_plan.PlanPolicy(
                n_workers=workers, strategy=strategy,
                max_np={"NVLINK": cap})).level("NVLINK")
            b = ref_plan.plan_run(r, ref_plan.Workload(**w),
                                  ref_plan.PlanPolicy(
                                      n_workers=workers, strategy=strategy,
                                      max_np={"ICI": cap})).level("ICI")
            for f in ("np_raw", "np", "extent", "fits", "partition_bytes"):
                assert getattr(a, f) == getattr(b, f), (state, workers, f)
            assert a.extent == min(8, cap)


@pytest.mark.parametrize("m,k,n,workers", [(512, 256, 384, 1),
                                           (1000, 64, 96, 3),
                                           (8192, 512, 2048, 4)])
def test_horizontal_at_the_tile_level(m, k, n, workers):
    """The horizontal baseline at the tile level: one row slab a worker,
    the whole K and N (``autotile.plan_matmul_horizontal``), as the
    reference's plans it at its VMEM level."""
    spec = h100_spec()
    # The card below its NVLINK level, as the reference's chip tree (HBM ->
    # VMEM -> VREG) has no mesh level: the worker count reaches the tile.
    card = spec.hierarchy().find("L2")
    tile = my_plan.plan_run(
        card, my_plan.Workload(matmul=(m, k, n)),
        my_plan.PlanPolicy(strategy="horizontal", n_workers=workers,
                           spec=spec)).tile_plan()
    from repro.hw.tpu import chip_spec
    ref = ref_plan.plan_run(
        chip_spec().hierarchy(), ref_plan.Workload(matmul=(m, k, n)),
        ref_plan.PlanPolicy(strategy="horizontal", n_workers=workers,
                            use_tuned=False)).tile_plan()
    for f in ("m", "k", "n", "bm", "bk", "bn", "np", "order", "strategy"):
        assert getattr(tile, f) == getattr(ref, f), f
    assert tile.strategy == "horizontal" and tile.bm == -(-m // workers)
    # The cache-conscious plan of the same shape stays the tuned search's.
    cc = my_plan.plan_run(card, my_plan.Workload(matmul=(m, k, n)),
                          my_plan.PlanPolicy(spec=spec, use_tuned=False))
    assert cc.tile_plan().strategy != "horizontal"


# ---------------------------------------------------------------------------
# launch.specs: the batch and cache records, footprints and wire bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    import jax
    import torch
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch import specs as ref_specs
    from repro.models.model import build_model
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs as my_specs

    cfg, rcfg = _configs(arch)
    shape, rshape = (ShapeConfig("s", 64, 8, "train"),
                     RefShape("s", 64, 8, "train"))
    mine = my_specs.train_batch_specs(cfg, shape)
    ref = ref_specs.train_batch_specs(rcfg, rshape)
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert tuple(mine[k].shape) == tuple(v.shape), k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    dm, dr = (my_specs.decode_batch_specs(cfg, shape),
              ref_specs.decode_batch_specs(rcfg, rshape))
    assert {k: tuple(v.shape) for k, v in dm.items()} == \
        {k: tuple(v.shape) for k, v in dr.items()}
    assert mine["labels"].dtype == torch.int32
    for kind in ("train", "decode"):
        assert my_specs.batch_logical_axes(cfg, kind) == \
            ref_specs.batch_logical_axes(rcfg, kind)
    for remat in ("full", "none", "dots"):
        assert my_specs.activation_footprint(cfg, shape, remat) == \
            ref_specs.activation_footprint(rcfg, rshape, remat)
    assert my_specs.decode_footprint(cfg, shape, 4096) == \
        ref_specs.decode_footprint(rcfg, rshape, 4096)
    # The cache's logical axes over the reference's cache leaves (shapes
    # only: jax.eval_shape allocates nothing).
    small = rcfg.reduced()
    cache = jax.eval_shape(lambda: build_model(small).init_cache(2, 64))
    for long_context in (False, True):
        assert my_specs.cache_logical_axes(cfg, cache, long_context) == \
            ref_specs.cache_logical_axes(rcfg, cache, long_context)


@pytest.mark.parametrize("kind", ["ag", "rs"])
@pytest.mark.parametrize("mode", ["ring", "serpentine"])
def test_overlap_wire_bytes_matches_reference(kind, mode):
    from repro.launch import specs as ref_specs
    from repro_torch.launch import specs as my_specs

    for m, k, n, p in ((8192, 2048, 2048, 4), (4096, 2048, 8192, 8),
                       (512, 64, 96, 1), (100, 30, 50, 3)):
        for el in (2, 4):
            assert my_specs.overlap_wire_bytes(m, k, n, p, kind, mode, el) \
                == ref_specs.overlap_wire_bytes(m, k, n, p, kind, mode, el)
    with pytest.raises(ValueError, match="kind must be"):
        my_specs.overlap_wire_bytes(8, 8, 8, 2, "ar")
