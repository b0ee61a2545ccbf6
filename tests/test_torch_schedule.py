"""The port's CC/SRRC schedules, affinity groups, ring order and grid order
against ``repro.core.schedule`` on hypothesis-drawn inputs, and the port's
own disjointness and full coverage."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as ref
import repro_torch.core as mine

GROUP_SHAPES = [(1, 1), (2, 2), (4, 4), (2, 4), (1, 4), (8, 2), (3, 5)]


@settings(max_examples=300, deadline=None)
@given(n_workers=st.integers(min_value=1, max_value=128),
       n_tasks=st.integers(min_value=0, max_value=10_000))
def test_cc_matches_reference_and_covers(n_workers, n_tasks):
    sched = mine.cc_schedule(n_workers, n_tasks)
    assert sched == ref.cc_schedule(n_workers, n_tasks)
    assert [t for s in sched for t in s] == list(range(n_tasks))
    sizes = [len(s) for s in sched]
    assert max(sizes) - min(sizes) <= 1
    for r in range(n_workers):
        assert mine.cc_range(r, n_workers, n_tasks) == \
            ref.cc_range(r, n_workers, n_tasks)
        assert mine.cc_worker_tasks(r, n_workers, n_tasks) == sched[r]


@settings(max_examples=200, deadline=None)
@given(n_tasks=st.integers(min_value=0, max_value=5000),
       ratio=st.integers(min_value=1, max_value=64),
       tcl=st.sampled_from([1, 4096, 64 << 10, 1 << 20]),
       group_shape=st.sampled_from(GROUP_SHAPES))
def test_srrc_matches_reference_and_covers(n_tasks, ratio, tcl, group_shape):
    n_groups, per_group = group_shape
    groups = [list(range(g * per_group, (g + 1) * per_group))
              for g in range(n_groups)]
    llc = ratio * tcl
    sched = mine.srrc_schedule(n_tasks, llc, tcl, groups)
    expected = ref.srrc_schedule(n_tasks, llc, tcl, groups)
    assert vars(sched) == vars(expected)
    assert mine.srrc_cluster_size(llc, tcl, per_group) == \
        ref.srrc_cluster_size(llc, tcl, per_group)
    flat = sorted(t for s in sched.assignment for t in s)
    assert flat == list(range(n_tasks))
    # Every full cluster stays inside one LLC group.
    cs = sched.cluster_size
    owner = {t: w for w, ts in enumerate(sched.assignment) for t in ts}
    for j in range(sched.n_full_clusters):
        holders = {owner[t] for t in range(j * cs, (j + 1) * cs)}
        assert holders <= set(groups[j % n_groups])
    # The synchronization-free stream of each rank equals its table row.
    for rank in range(n_groups * per_group):
        stream = list(mine.srrc_worker_tasks(rank, n_tasks, llc, tcl,
                                             groups))
        assert stream == sched.assignment[rank]
        assert stream == list(ref.srrc_worker_tasks(rank, n_tasks, llc, tcl,
                                                    groups))


@pytest.mark.parametrize("system", ["paper_system_a", "paper_system_i"])
def test_affinity_groups_match_reference(system, tmp_path):
    from test_torch_hierarchy import SYSFS_TREES, make_sysfs

    trees = [(getattr(mine, system)(), getattr(ref, system)())]
    for name, tree in SYSFS_TREES.items():
        root = make_sysfs(tmp_path / name, tree)
        trees.append((mine.read_linux_hierarchy(root),
                      ref.read_linux_hierarchy(root)))
    for h, r in trees:
        assert mine.lowest_level_shared_cache_groups(h) == \
            ref.lowest_level_shared_cache_groups(r)
    groups = mine.lowest_level_shared_cache_groups(trees[0][0])
    assert groups == ([[0, 1, 2, 3], [4, 5, 6, 7]] if system.endswith("a")
                      else [[0, 1], [2, 3], [4, 5], [6, 7]])


@settings(max_examples=60, deadline=None)
@given(p=st.integers(min_value=1, max_value=16),
       strategy=st.sampled_from(["cc", "srrc"]))
def test_ring_stream_order_matches_reference(p, strategy):
    order = mine.ring_stream_order(p, strategy)
    assert order == ref.ring_stream_order(p, strategy)
    for d in range(len(order[0])):
        assert sorted(step[d] for step in order) == list(range(p))


def test_ring_stream_order_rejects_what_the_reference_rejects():
    for p, strategy in ((0, "cc"), (4, "zigzag")):
        with pytest.raises(ValueError):
            mine.ring_stream_order(p, strategy)
        with pytest.raises(ValueError):
            ref.ring_stream_order(p, strategy)


@settings(max_examples=100, deadline=None)
@given(gm=st.integers(min_value=1, max_value=8),
       gn=st.integers(min_value=1, max_value=8),
       gk=st.integers(min_value=1, max_value=8),
       rank=st.integers(min_value=1, max_value=3),
       strategy=st.sampled_from(["cc", "srrc"]))
def test_grid_order_matches_reference(gm, gn, gk, rank, strategy):
    grid = (gm, gn, gk)[:rank]
    order = mine.grid_order(grid, strategy)
    assert order == ref.grid_order(grid, strategy)
    assert sorted(order) == sorted(set(order))
    assert len(order) == gm * (gn if rank > 1 else 1) * \
        (gk if rank > 2 else 1)
    if strategy == "srrc" and rank > 1:
        for a, b in zip(order, order[1:]):     # one step at a time
            assert a[0] == b[0] or b[0] == a[0] + 1
