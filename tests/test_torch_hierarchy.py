"""The port's memory hierarchy against ``repro.core.hierarchy``: the sysfs
reader on the same synthetic trees, the paper's JSON schema both ways
between the packages, and the paper's two systems."""

import pytest

import repro.core as ref
import repro_torch.core as mine

#: Synthetic sysfs trees: cpu -> [(level, size, type, shared_cpu_list)].
#: ``None`` as the list leaves the ``shared_cpu_list`` file out.
_TWO_CPUS = {cpu: [(1, "32K", "Data", f"{cpu}"),
                   (1, "32K", "Instruction", f"{cpu}"),
                   (2, "1024K", "Unified", "0-1")] for cpu in (0, 1)}

# Two sockets of two cores with two hardware threads each: SMT pairs share
# L1d and L2, each socket has its own L3.
_SMT_PAIR = {c: f"{c & ~1}-{c | 1}" for c in range(8)}
_TWO_SOCKETS = {cpu: [(1, "48K", "Data", _SMT_PAIR[cpu]),
                      (1, "32K", "Instruction", _SMT_PAIR[cpu]),
                      (2, "2048K", "Unified", _SMT_PAIR[cpu]),
                      (3, "30720K", "Unified", "0-3" if cpu < 4 else "4-7")]
                for cpu in range(8)}

_NO_CACHE = {cpu: [] for cpu in range(4)}

_NO_SHARED_LIST = {cpu: [(1, "32K", "Data", None), (2, "512K", "Unified",
                                                    None)]
                   for cpu in range(4)}

SYSFS_TREES = {"two_cpus": _TWO_CPUS, "two_sockets": _TWO_SOCKETS,
               "no_cache": _NO_CACHE, "no_shared_list": _NO_SHARED_LIST}


def make_sysfs(root, tree) -> str:
    """Write ``tree`` as a fake ``/sys/devices/system/cpu`` under ``root``."""
    for cpu, entries in tree.items():
        (root / f"cpu{cpu}").mkdir(parents=True, exist_ok=True)
        for idx, (lvl, size, typ, shared) in enumerate(entries):
            d = root / f"cpu{cpu}" / "cache" / f"index{idx}"
            d.mkdir(parents=True)
            (d / "level").write_text(str(lvl))
            (d / "size").write_text(size)
            (d / "type").write_text(typ)
            (d / "coherency_line_size").write_text("64")
            if shared is not None:
                (d / "shared_cpu_list").write_text(shared)
    return str(root)


def _props(h) -> list:
    """Every derived quantity of every level, comparable across packages."""
    return [(l.name, l.size, l.cache_line_size, l.siblings, l.n_cores,
             l.cores_per_copy, l.per_core_size()) for l in h.levels()]


def _name(level):
    return None if level is None else level.name


def assert_same_tree(a, b):
    assert a.to_dict() == b.to_dict()
    assert _props(a) == _props(b)
    assert [l.name for l in a.cache_levels()] == \
        [l.name for l in b.cache_levels()]
    assert _name(a.llc()) == _name(b.llc())
    assert _name(a.lowest_shared_cache()) == _name(b.lowest_shared_cache())


@pytest.mark.parametrize("tree", sorted(SYSFS_TREES))
def test_sysfs_reader_matches_reference(tmp_path, tree):
    root = make_sysfs(tmp_path, SYSFS_TREES[tree])
    h = mine.read_linux_hierarchy(root)
    assert_same_tree(h, ref.read_linux_hierarchy(root))
    names = [l.name for l in h.levels()]
    if tree == "no_cache":
        # A partial sysfs gives RAM only, and no L1 to decompose against.
        assert names == ["RAM"] and h.llc() is None
        assert h.lowest_shared_cache() is None
        with pytest.raises(KeyError):
            mine.Decomposer(h, tcl="L1")
        with pytest.raises(KeyError):
            ref.Decomposer(ref.read_linux_hierarchy(root), tcl="L1")
    elif tree == "two_sockets":
        assert names == ["RAM", "L3", "L2", "L1"]
        assert h.find("L3").siblings == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert h.find("L1").siblings == [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert h.lowest_shared_cache() is h.find("L1")
        assert h.n_cores == 8
    elif tree == "two_cpus":
        assert h.lowest_shared_cache() is h.find("L2")
        assert h.find("L1").per_core_size() == 32 * 1024
    else:
        # Without shared_cpu_list every cache is private to each cpu.
        assert h.find("L2").siblings == [[0], [1], [2], [3]]
        assert h.lowest_shared_cache() is h.find("L2")   # falls to the LLC


def test_sysfs_reader_on_this_host_matches_reference():
    try:
        expected = ref.read_linux_hierarchy()
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            mine.read_linux_hierarchy()
        return
    assert_same_tree(mine.read_linux_hierarchy(), expected)


@pytest.mark.parametrize("size,parsed", [("32K", 32768), ("1024K", 1 << 20),
                                         ("8M", 8 << 20), ("1G", 1 << 30),
                                         ("64", 64), ("48KB", 49152)])
def test_size_and_cpu_list_parsers_match_reference(size, parsed):
    from repro.core.hierarchy import _parse_cpu_list as ref_cpus
    from repro.core.hierarchy import _parse_size as ref_size
    from repro_torch.core.hierarchy import _parse_cpu_list, _parse_size

    assert _parse_size(size) == ref_size(size) == parsed
    for s in ("0-3,8,10-11", "5", "", "0-1,"):
        assert _parse_cpu_list(s) == ref_cpus(s)


def _trees():
    """Each tree once, in the reference's package."""
    return {
        "system_a": ref.paper_system_a(),
        "system_i": ref.paper_system_i(),
        "tpu_mesh": ref.tpu_hierarchy(16 << 30, 128 << 20, mesh_devices=4),
    }


@pytest.mark.parametrize("name", ["system_a", "system_i", "tpu_mesh", "h100"])
def test_json_both_ways_between_the_packages(name):
    if name == "h100":
        src = mine.h100_hierarchy(80 << 30, 232_448, 50 << 20)
        there = ref.MemoryLevel.from_json(src.to_json())
        back = mine.MemoryLevel.from_json(there.to_json())
        assert there.to_dict() == src.to_dict()
    else:
        src = _trees()[name]
        here = mine.MemoryLevel.from_json(src.to_json())
        back = ref.MemoryLevel.from_json(here.to_json())
        assert_same_tree(here, src)
    assert back.to_dict() == src.to_dict()


def test_listing_1_schema_keys():
    d = mine.paper_system_a().to_dict()
    assert set(d) == {"size", "siblings", "name", "child"}   # RAM: no line
    assert set(d["child"]) == {"size", "siblings", "cacheLineSize", "name",
                               "child"}
    # A tree without names (the paper's own Listing 1) reads as well.
    bare = {"size": 1 << 30, "siblings": [[0, 1]], "child": {
        "size": 65536, "siblings": [[0], [1]], "cacheLineSize": 64,
        "child": None}}
    h = mine.MemoryLevel.from_dict(bare)
    assert h.to_dict() == ref.MemoryLevel.from_dict(bare).to_dict()
    assert h.llc().size == 65536 and h.lowest_shared_cache() is h.llc()


@pytest.mark.parametrize("system", ["paper_system_a", "paper_system_i"])
def test_paper_systems_match_reference(system):
    h = getattr(mine, system)()
    assert_same_tree(h, getattr(ref, system)())
    assert h.n_cores == 8
    assert h.llc() is h.find("L3")
    if system == "paper_system_a":
        assert h.find("L3").cores_per_copy == 4
        assert h.lowest_shared_cache() is h.find("L3")
    else:
        assert h.find("L1").siblings == [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert h.lowest_shared_cache() is h.find("L1")
