"""The port's decomposition against ``repro.core``: the phi estimators, the
§2.1.1 search, the ``Decomposer`` under both strategies with the TCL given
by name and by bytes, and ``plan_run``'s cache path (``domain``, ``tcl=``,
``describe``) on the paper's systems and a synthetic sysfs tree, and its
mesh level over cards; the register level (``REG`` here, ``VREG`` there)
and the page rule's ``domain is None``."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as ref
import repro.core.distribution as ref_dist
import repro.core.plan as ref_plan
import repro_torch.core as mine
import repro_torch.core.plan as my_plan
from test_torch_hierarchy import SYSFS_TREES, make_sysfs

KB = 1024


@pytest.fixture(autouse=True)
def _no_tuning_artifact(monkeypatch, tmp_path):
    """The planner sees no tuning artifact, whatever the machine holds."""
    monkeypatch.setenv("REPRO_TORCH_TUNING", str(tmp_path / "absent.json"))


def test_paper_worked_examples():
    dom = mine.matmul_domain(1024, 1024, 1024, element_size=4)
    assert sum(mine.phi_simple(64, d, 256) for d in dom) == 49152
    assert sum(mine.phi_conservative(64, d, 256) for d in dom) == 98304
    assert mine.validate_np(64 * KB, 64, list(dom), 256) == 1
    assert mine.validate_np(64 * KB, 64, list(dom), 256,
                            mine.phi_conservative) == 0
    big = mine.matmul_domain(2000, 2000, 2000, element_size=4)
    np_ = mine.find_optimal_np(128 * KB, 64, big, n_workers=8)
    assert np_ == 400 and len(mine.matmul_task_grid(np_)) == 8000


def _dist(kind, a, b, es, extra):
    if kind == "array1d":
        return dict(length=a * b, element_size=es, indivisible=extra), \
            "Array1DDistribution"
    if kind == "stencil":
        return dict(rows=a, cols=b, element_size=es, halo=extra), \
            "StencilDistribution"
    return dict(rows=a, cols=b, element_size=es), {
        "rowblock": "RowBlockDistribution",
        "block2d": "Array2DBlockDistribution"}[kind]


def _search(pkg, *args, **kw):
    try:
        return pkg.find_optimal_np(*args, **kw)
    except pkg.NoValidDecomposition:
        return "none"


@settings(max_examples=100, deadline=None)
@given(kind=st.sampled_from(["array1d", "rowblock", "block2d", "stencil"]),
       a=st.integers(min_value=1, max_value=512),
       b=st.integers(min_value=1, max_value=512),
       es=st.sampled_from([1, 4, 8]),
       extra=st.integers(min_value=1, max_value=3),
       line=st.sampled_from([16, 64, 128]),
       tcl=st.integers(min_value=64, max_value=1 << 20),
       workers=st.integers(min_value=1, max_value=16),
       conservative=st.booleans())
def test_phi_and_search_match_reference(kind, a, b, es, extra, line, tcl,
                                        workers, conservative):
    args, cls = _dist(kind, a, b, es, extra)
    d, r = getattr(mine, cls)(**args), getattr(ref, cls)(**args)
    phi_m = mine.phi_conservative if conservative else mine.phi_simple
    phi_r = ref.phi_conservative if conservative else ref.phi_simple
    for np_ in (1, 2, 4, 9, 16, 25, 100):
        assert phi_m(line, d, np_) == phi_r(line, r, np_)
        assert mine.validate_np(tcl, line, [d], np_, phi_m) == \
            ref.validate_np(tcl, line, [r], np_, phi_r)
    dom_m = [d, mine.ReplicatedDistribution(min(tcl // 4, 4096))]
    dom_r = [r, ref_dist.ReplicatedDistribution(min(tcl // 4, 4096))]
    assert _search(mine, tcl, line, dom_m, workers, phi_m, max_np=4096) == \
        _search(ref, tcl, line, dom_r, workers, phi_r, max_np=4096)


def _domains(pkg):
    return {
        "matmul96": pkg.matmul_domain(96, 96, 96, 4),
        "matmul768": pkg.matmul_domain(768, 768, 768, 4),
        "sor2048": [pkg.StencilDistribution(2048, 2048, 4, halo=1)],
        "crypt": [pkg.Array1DDistribution(1 << 20, 1, indivisible=64)],
        "rows": [pkg.RowBlockDistribution(4096, 300, 8)],
    }


def _hierarchies(tmp_path):
    root = make_sysfs(tmp_path, SYSFS_TREES["two_sockets"])
    return {
        "system_a": (mine.paper_system_a(), ref.paper_system_a()),
        "system_i": (mine.paper_system_i(), ref.paper_system_i()),
        "sysfs": (mine.read_linux_hierarchy(root),
                  ref.read_linux_hierarchy(root)),
    }


def _decompose(dec, dom, workers):
    try:
        return dec.decompose(dom, workers)
    except (mine.NoValidDecomposition, ref.NoValidDecomposition) as exc:
        return type(exc).__name__


@pytest.mark.parametrize("tcl", ["L1", "L2", "L3", 16 * KB, 128 * KB])
@pytest.mark.parametrize("strategy", ["cache_conscious", "horizontal"])
@pytest.mark.parametrize("system", ["system_a", "system_i", "sysfs"])
def test_decomposer_matches_reference(tmp_path, system, strategy, tcl):
    h, r = _hierarchies(tmp_path)[system]
    for conservative in (False, True):
        phis = ((mine.phi_conservative, ref.phi_conservative) if conservative
                else (mine.phi_simple, ref.phi_simple))
        dec = mine.Decomposer(h, tcl=tcl, phi=phis[0], strategy=strategy)
        rdec = ref.Decomposer(r, tcl=tcl, phi=phis[1], strategy=strategy)
        assert (dec.tcl_bytes, dec.cache_line) == \
            (rdec.tcl_bytes, rdec.cache_line)
        doms, rdoms = _domains(mine), _domains(ref)
        for name in doms:
            for workers in (1, 4, 8):
                p = _decompose(dec, doms[name], workers)
                q = _decompose(rdec, rdoms[name], workers)
                if isinstance(q, str):
                    assert p == q, (name, workers)
                    continue
                assert (p.np, p.tcl_bytes, p.cache_line_size, p.strategy) \
                    == (q.np, q.tcl_bytes, q.cache_line_size, q.strategy)
                assert p.partition_bytes == \
                    pytest.approx(q.partition_bytes, rel=1e-6)
                assert p.regions == q.regions, (name, workers)
                if strategy == "cache_conscious":
                    assert p.np >= workers


def _cache_policy(pkg, pkg_plan, strategy, tcl, workers, conservative):
    phi = pkg.phi_conservative if conservative else pkg.phi_simple
    return pkg_plan.PlanPolicy(strategy=strategy, n_workers=workers,
                               cache_phi=phi, tcl=tcl)


@pytest.mark.parametrize("tcl", [None, "L2"])
@pytest.mark.parametrize("strategy", ["cache_conscious", "horizontal"])
@pytest.mark.parametrize("system", ["system_a", "system_i", "sysfs"])
def test_plan_run_cache_path_and_describe_match_reference(tmp_path, system,
                                                          strategy, tcl):
    h, r = _hierarchies(tmp_path)[system]
    for name, dom in _domains(mine).items():
        rdom = _domains(ref)[name]
        for workers, conservative in ((1, False), (4, True), (8, False)):
            hp = my_plan.plan_run(
                h, my_plan.Workload(domain=tuple(dom)),
                _cache_policy(mine, my_plan, strategy, tcl, workers,
                              conservative))
            rp = ref_plan.plan_run(
                r, ref_plan.Workload(domain=tuple(rdom)),
                _cache_policy(ref, ref_plan, strategy, tcl, workers,
                              conservative))
            assert hp.describe() == rp.describe(), (name, workers)
            kinds = [lp.kind for lp in hp.levels()]
            assert kinds == [lp.kind for lp in rp.levels()]
            if tcl is None:
                assert kinds == ["container"] + ["cache"] * (len(kinds) - 1)
            else:
                assert [lp.level for lp in hp.levels()
                        if lp.kind == "cache"] == ["L2"]
            for a, b in zip(hp.levels(), rp.levels()):
                assert (a.np_raw, a.np, a.n_workers, a.fits, a.budget_bytes,
                        a.granule_bytes) == (b.np_raw, b.np, b.n_workers,
                                             b.fits, b.budget_bytes,
                                             b.granule_bytes)
                assert a.partition_bytes == \
                    pytest.approx(b.partition_bytes, rel=1e-6)
            assert my_plan.HierarchicalPlan.from_json(hp.to_json()) == hp


def _as_reference(tree, names):
    """``tree`` in the reference's package, its levels renamed."""
    d = tree.to_dict()
    node = d
    while node is not None:
        node["name"] = names.get(node["name"], node["name"])
        node = node["child"]
    return ref.MemoryLevel.from_dict(d)


_REF_NAMES = {"NVLINK": "ICI", "REG": "VREG"}


def _renamed(lines):
    for mine_name, ref_name in _REF_NAMES.items():
        lines = [l.replace(f"{mine_name}[", f"{ref_name}[") for l in lines]
    return lines


@pytest.mark.parametrize("subtree", ["card", "hbm"])
def test_register_level_is_no_cache_level(subtree):
    """``REG`` is the port's register file, as ``VREG`` is the reference's:
    a domain on ``h100_hierarchy`` searches L2 and SMEM, never REG."""
    h = mine.h100_hierarchy(80 * 10 ** 9, 232_448, 50 << 20)
    if subtree == "hbm":
        h = h.child
    r = _as_reference(h, _REF_NAMES)
    dom = _domains(mine)["matmul96"]
    hp = my_plan.plan_run(h, my_plan.Workload(domain=tuple(dom)),
                          my_plan.PlanPolicy(n_workers=4))
    rp = ref_plan.plan_run(r, ref_plan.Workload(
        domain=tuple(_domains(ref)["matmul96"])),
        ref_plan.PlanPolicy(n_workers=4))
    assert _renamed(hp.describe()) == rp.describe()
    assert hp.level("REG").kind == "leaf"
    assert [lp.level for lp in hp.levels() if lp.kind == "cache"] == \
        ["L2", "SMEM"]


def test_page_rule_needs_no_domain():
    """A domain workload with KV terms takes the cache path, not the page
    path, as in the reference (whose page levels include L2)."""
    h = mine.h100_hierarchy(80 * 10 ** 9, 232_448, 50 << 20)
    kv = dict(kv_bytes_per_token=16384, kv_layers=16, kv_heads=8,
              max_tokens=4096)
    dom = _domains(mine)["sor2048"]
    hp = my_plan.plan_run(h, my_plan.Workload(domain=tuple(dom), **kv))
    rp = ref_plan.plan_run(_as_reference(h, _REF_NAMES), ref_plan.Workload(
        domain=tuple(_domains(ref)["sor2048"]), **kv))
    assert hp.page_plan() is None and rp.page_plan() is None
    assert _renamed(hp.describe()) == rp.describe()
    # Without the domain the same tree plans a page at SMEM.
    assert my_plan.plan_run(h, my_plan.Workload(**kv)).level("SMEM").kind \
        == "page"


def _mesh_trees(copies):
    """An NVLINK level over ``copies`` cards' HBM, and the reference's ICI
    over as many chips' HBM, each over a host-style cache level."""
    l2 = mine.MemoryLevel(50 << 20, [[c] for c in range(copies)], 128, None,
                          "L2")
    hbm = mine.MemoryLevel(80 << 30, [[c] for c in range(copies)], None, l2,
                           "HBM")
    h = mine.MemoryLevel(copies * (80 << 30), [list(range(copies))], None,
                         hbm, "NVLINK")
    return h, _as_reference(h, _REF_NAMES)


@pytest.mark.parametrize("copies", [1, 2, 4, 8])
def test_mesh_level_over_cards_matches_the_reference(copies):
    h, r = _mesh_trees(copies)
    for state, workers in ((100 << 30, 1), (500 << 30, 2), (1 << 20, 4)):
        hp = my_plan.plan_run(
            h, my_plan.Workload(state_bytes=state, replicated_bytes=2 << 30),
            my_plan.PlanPolicy(n_workers=workers))
        rp = ref_plan.plan_run(
            r, ref_plan.Workload(state_bytes=state, replicated_bytes=2 << 30),
            ref_plan.PlanPolicy(n_workers=workers))
        assert _renamed(hp.describe()) == rp.describe()
        mesh, rmesh = hp.level("NVLINK"), rp.level("ICI")
        assert (mesh.np_raw, mesh.np, mesh.extent, mesh.fits) == \
            (rmesh.np_raw, rmesh.np, rmesh.extent, rmesh.fits)
        assert mesh.extent == copies and mesh.np <= mesh.extent


def test_cache_path_needs_no_card_spec_and_no_tuning(monkeypatch, tmp_path):
    def refuse(*_a, **_k):
        raise AssertionError("the cache path reached the card's spec or "
                             "the tuning artifact")

    from repro_torch.tune import cache as tune_cache

    monkeypatch.setattr(my_plan, "_default_spec", refuse)
    monkeypatch.setattr(tune_cache, "lookup_tuned", refuse)
    dom = _domains(mine)["matmul768"]
    trees = [h for h, _ in _hierarchies(tmp_path).values()]
    trees.append(mine.h100_hierarchy(80 * 10 ** 9, 232_448, 50 << 20))
    for h in trees:
        for tcl in ("L2", 64 * KB):
            for strategy in ("cache_conscious", "horizontal"):
                plan = mine.Decomposer(h, tcl=tcl, strategy=strategy) \
                    .decompose(dom, 4)
                # The card's NVLINK level over one card takes the 4 workers
                # down to 1, as the reference's ICI level over one chip.
                assert plan.np >= (4 if h.name == "RAM" else 1)
                assert len(plan.regions) == 3
    hp = my_plan.plan_run(trees[-1], my_plan.Workload(domain=tuple(dom)))
    assert [lp.kind for lp in hp.levels()] == \
        ["mesh", "cache", "cache", "leaf"]


def test_tile_line_names_shared_memory():
    card = mine.h100_hierarchy(80 * 10 ** 9, 232_448, 50 << 20).child
    hp = my_plan.plan_run(card, my_plan.Workload(matmul=(1024, 256, 512)),
                          my_plan.PlanPolicy(n_workers=4, use_tuned=False))
    (line,) = [l for l in hp.describe() if "[tile]" in l]
    assert "smem=" in line and "vmem=" not in line
    t = hp.tile_plan()
    assert f"block={t.bm}x{t.bk}x{t.bn} " in line


def test_plan_surface():
    import repro.plan as ref_surface
    import repro_torch.plan as surface

    assert surface.plan_run is my_plan.plan_run
    assert set(surface.__all__) == set(ref_surface.__all__) | {"PlanError"}
    err = surface.PlanError("no", level="DCN", plan=None)
    assert isinstance(err, RuntimeError)
    assert (err.level, err.plan, str(err)) == ("DCN", None, "no")
