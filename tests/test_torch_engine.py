"""The port's synchronization-free ``Engine`` against ``repro.core.engine``:
a small MatMult (n = 64, TCL 4 KiB) and a small SOR (128 x 128, 2 sweeps),
with the bodies of ``chip_smoke.py``'s phase 31, under both strategies,
both schedules, 1 and 4 workers, in threads and on the calling thread;
results equal to a plain computation and to the reference engine's on the
same numpy inputs; the schedule tables and worker groups equal to the
reference's; the stage times; and phase 31 itself at a small size."""

import importlib.util
import os
import sys

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as mine
from test_torch_hierarchy import SYSFS_TREES, make_sysfs

N, TCL = 64, 4 * 1024
SOR_N, SWEEPS = 128, 2


def _chip_smoke():
    """``chip_smoke.py``: its phase 31 bodies are what these tests run."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


def _engines(**kw):
    return (mine.Engine(mine.paper_system_a(), **kw),
            ref.Engine(ref.paper_system_a(), **kw))


def _check_times(res):
    t = res.times
    stages = (t.decomposition, t.scheduling, t.execution, t.reduction)
    assert all(s >= 0 for s in stages)
    assert t.total == pytest.approx(sum(stages), rel=1e-12)
    assert t.total > 0


CASES = pytest.mark.parametrize("n_workers,parallel", [(1, False),
                                                       (1, True),
                                                       (4, False),
                                                       (4, True)])


@CASES
@pytest.mark.parametrize("schedule", ["cc", "srrc"])
@pytest.mark.parametrize("strategy", ["cache_conscious", "horizontal"])
def test_matmul_equals_plain_and_reference(strategy, schedule, n_workers,
                                           parallel):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, N)).astype(np.float32)
    B = rng.standard_normal((N, N)).astype(np.float32)
    eng, reng = _engines(n_workers=n_workers, tcl=TCL, schedule=schedule,
                         strategy=strategy, parallel=parallel)
    C, (res,) = CHIP.paper_matmul(mine, eng, A, B)
    rC, (rres,) = CHIP.paper_matmul(ref, reng, A, B)
    exact = A.astype(np.float64) @ B.astype(np.float64)
    assert (np.abs(C - exact) <= 2e-4 * (1 + np.abs(exact))).all()
    if parallel and n_workers > 1:
        # The k-sums of one C block land in the order the locks grant.
        np.testing.assert_allclose(C, rC, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(C, rC)
    assert (res.np, res.n_tasks) == (rres.np, rres.n_tasks)
    side = round(res.np ** 0.5)
    assert res.n_tasks == side ** 3
    if strategy == "cache_conscious":
        assert res.np > n_workers
    _check_times(res)


@CASES
@pytest.mark.parametrize("schedule", ["cc", "srrc"])
@pytest.mark.parametrize("strategy", ["cache_conscious", "horizontal"])
def test_sor_equals_plain_and_reference_exactly(strategy, schedule,
                                                n_workers, parallel):
    grid = np.random.default_rng(3).standard_normal(
        (SOR_N, SOR_N)).astype(np.float32)
    eng, reng = _engines(n_workers=n_workers, tcl="L1", schedule=schedule,
                         strategy=strategy, parallel=parallel)
    out, runs = CHIP.paper_sor(mine, eng, grid, SWEEPS)
    rout, rruns = CHIP.paper_sor(ref, reng, grid, SWEEPS)
    np.testing.assert_array_equal(out, CHIP.plain_sor(grid, SWEEPS))
    np.testing.assert_array_equal(out, rout)
    assert len(runs) == SWEEPS
    for res, rres in zip(runs, rruns):
        assert (res.np, res.n_tasks) == (rres.np, rres.n_tasks)
        assert res.n_tasks == res.np
        _check_times(res)


def _trees(tmp_path):
    out = [(mine.paper_system_a(), ref.paper_system_a()),
           (mine.paper_system_i(), ref.paper_system_i())]
    for name, tree in SYSFS_TREES.items():
        root = make_sysfs(tmp_path / name, tree)
        out.append((mine.read_linux_hierarchy(root),
                    ref.read_linux_hierarchy(root)))
    return out


def test_assign_and_worker_groups_match_reference(tmp_path):
    for h, r in _trees(tmp_path):
        for n_workers in range(1, 13):
            for tcl in (TCL, 64 * 1024):
                for schedule in ("cc", "srrc"):
                    eng = mine.Engine(h, n_workers, tcl=tcl,
                                      schedule=schedule)
                    reng = ref.Engine(r, n_workers, tcl=tcl,
                                      schedule=schedule)
                    assert eng._worker_groups() == reng._worker_groups()
                    for n_tasks in (0, 1, 7, 64, 343, 1000):
                        table = eng._assign(n_tasks)
                        assert table == reng._assign(n_tasks)
                        assert sorted(t for row in table for t in row) == \
                            list(range(n_tasks))
    with pytest.raises(ValueError):
        mine.Engine(mine.paper_system_a(), 2, schedule="zigzag")._assign(4)


def test_threads_write_disjoint_slots_under_a_short_switch_interval():
    """More workers than cores, the interpreter switching threads every
    microsecond: every task runs once and its result lands in its slot."""
    d = mine.Array1DDistribution(length=50_000, element_size=8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for schedule in ("cc", "srrc"):
            eng = mine.Engine(mine.paper_system_a(), n_workers=32, tcl=1024,
                              schedule=schedule, parallel=True)
            res = eng.run([d], lambda task: (task[0][0].start,
                                             task[0][0].stop))
            assert res.n_tasks == res.np >= 32
            assert res.results == [(sl.start, sl.stop)
                                   for (sl,) in d.partition(res.np)]
            assert sum(b - a for a, b in res.results) == 50_000
    finally:
        sys.setswitchinterval(old)


def test_a_failing_task_fails_the_run():
    eng = mine.Engine(mine.paper_system_a(), n_workers=4, tcl=1024)

    def compute(task):
        if task[0][0].start == 0:
            raise RuntimeError("task 0")
        return 1

    with pytest.raises(RuntimeError, match="task 0"):
        eng.run([mine.Array1DDistribution(4096, 4)], compute)


def test_reduce_and_default_tasks_match_reference():
    kw = dict(n_workers=4, tcl=2048, schedule="srrc")
    eng, reng = _engines(**kw)
    d = [mine.Array1DDistribution(10_000, 8, indivisible=4)]
    rd = [ref.Array1DDistribution(10_000, 8, indivisible=4)]

    def compute(task):
        return task[0][0].stop - task[0][0].start

    res = eng.run(d, compute, reduce_fn=sum)
    rres = reng.run(rd, compute, reduce_fn=sum)
    assert res.results == rres.results == [10_000]
    assert (res.np, res.n_tasks) == (rres.np, rres.n_tasks)


@pytest.mark.parametrize("sysfs", ["two_cpus", "no_cache"])
def test_phase_31_at_a_small_size(monkeypatch, tmp_path, sysfs):
    """The phase's own path on this CPU at a small size, over a synthetic
    sysfs tree: every run is checked, both strategies share each
    configuration's ratio, a tree with caches runs as the host's, and a
    tree without caches runs on ``paper_system_a``, labelled so."""
    import torch

    monkeypatch.setattr(CHIP, "PAPER_MM", (N, "L2"))
    monkeypatch.setattr(CHIP, "PAPER_SOR", (SOR_N, SWEEPS, "L1"))
    root = make_sysfs(tmp_path, SYSFS_TREES[sysfs])
    real = mine.read_linux_hierarchy
    monkeypatch.setattr(mine, "read_linux_hierarchy", lambda: real(root))
    threads = torch.get_num_threads()
    out = CHIP.phase_paper_engine("no card")
    assert torch.get_num_threads() == threads
    assert out["tree"] == ("paper_system_a" if sysfs == "no_cache"
                           else "host")
    rows = out["runs"]
    assert len(rows) == 2 * 3 * 2        # benches x configs x strategies
    for a, b in zip(rows[::2], rows[1::2]):
        assert (a["strategy"], b["strategy"]) == ("cache_conscious",
                                                  "horizontal")
        assert a["horizontal_over_cc"] == b["horizontal_over_cc"] > 0
        assert a["n_workers"] == b["n_workers"]
