"""The port's distributions against ``repro.core.distribution`` on
hypothesis-drawn sizes: admissibility, the phi geometry, ``partition``,
``total_elements``, ``get_indivisible_size``, ``halo_region`` and the
Fig. 3 task grid; and the port's own cover of each domain."""

from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.distribution as ref
import repro_torch.core.distribution as mine

NPS = range(1, 50)


def _pair(kind, a, b, es, extra):
    """The same distribution in both packages."""
    if kind == "Array1DDistribution":
        args = dict(length=a * b, element_size=es, indivisible=extra)
    elif kind == "ReplicatedDistribution":
        args = dict(nbytes=a * b * es)
    elif kind == "StencilDistribution":
        args = dict(rows=a, cols=b, element_size=es, halo=extra)
    else:
        args = dict(rows=a, cols=b, element_size=es)
    return getattr(mine, kind)(**args), getattr(ref, kind)(**args)


def _cells(region, shape):
    """The flat indices a region of a ``shape`` array covers."""
    if len(region) == 1:
        return set(range(*region[0].indices(shape[0] * shape[1])))
    rs, cs = region
    return {r * shape[1] + c for r in range(*rs.indices(shape[0]))
            for c in range(*cs.indices(shape[1]))}


@settings(max_examples=100, deadline=None)
@given(kind=st.sampled_from(["Array1DDistribution", "ReplicatedDistribution",
                             "RowBlockDistribution",
                             "Array2DBlockDistribution",
                             "StencilDistribution"]),
       a=st.integers(min_value=1, max_value=96),
       b=st.integers(min_value=1, max_value=96),
       es=st.sampled_from([1, 2, 4, 8]),
       extra=st.integers(min_value=1, max_value=4))
def test_every_distribution_matches_reference(kind, a, b, es, extra):
    d, r = _pair(kind, a, b, es, extra)
    assert d.total_elements == r.total_elements
    assert d.get_element_size() == r.get_element_size()
    for np_ in NPS:
        assert d.validate(np_) == r.validate(np_), np_
        assert d.get_indivisible_size(np_) == r.get_indivisible_size(np_)
        assert d.get_average_partition_size(np_) == \
            r.get_average_partition_size(np_)
        assert d.get_average_first_dim_size(np_) == \
            r.get_average_first_dim_size(np_)
        regions = d.partition(np_)
        assert regions == r.partition(np_), np_
        if kind == "StencilDistribution":
            for reg in regions:
                assert d.halo_region(reg) == r.halo_region(reg)
        if d.validate(np_) <= 0 or kind == "ReplicatedDistribution":
            continue
        # A valid np covers the domain once, in np regions.  A 1-D domain
        # whose length is not a whole number of indivisible units loses
        # its last part-unit, in the reference as here.
        shape = (a, b)
        covered = a * b - (a * b) % extra if kind == "Array1DDistribution" \
            else a * b
        cells = [_cells(reg, shape) for reg in regions]
        assert len(regions) == np_
        assert sum(len(c) for c in cells) == covered
        assert set().union(*cells) == set(range(covered))


@settings(max_examples=100, deadline=None)
@given(rows=st.integers(min_value=3, max_value=200),
       cols=st.integers(min_value=3, max_value=200),
       halo=st.integers(min_value=1, max_value=3),
       np_=st.sampled_from([1, 4, 9, 16, 25, 36]))
def test_halo_region_extends_each_block_within_the_grid(rows, cols, halo,
                                                        np_):
    d = mine.StencilDistribution(rows, cols, 4, halo=halo)
    r = ref.StencilDistribution(rows, cols, 4, halo=halo)
    for reg in d.partition(np_):
        ext = d.halo_region(reg)
        assert ext == r.halo_region(reg)
        for inner, outer, n in zip(reg, ext, (rows, cols)):
            assert outer.start == max(0, inner.start - halo)
            assert outer.stop == min(n, inner.stop + halo)


@settings(max_examples=60, deadline=None)
@given(np_=st.integers(min_value=1, max_value=400))
def test_matmul_task_grid_matches_reference(np_):
    grid = mine.matmul_task_grid(np_)
    assert grid == ref.matmul_task_grid(np_)
    side = round(np_ ** 0.5)
    assert len(grid) == side ** 3 and len(set(grid)) == len(grid)


def test_matmul_domain_matches_reference():
    d = mine.matmul_domain(96, 64, 32, 4)
    r = ref.matmul_domain(96, 64, 32, 4)
    assert [vars(x) for x in d] == [vars(x) for x in r]
    assert [x.partition(16) for x in d] == [x.partition(16) for x in r]


def test_regions_index_numpy_and_torch_alike():
    import numpy as np
    import torch

    a = np.arange(12 * 10, dtype=np.float32).reshape(12, 10)
    t = torch.from_numpy(a)
    for reg in mine.StencilDistribution(12, 10, 4).partition(4):
        view = t[reg]
        assert view.data_ptr() != 0 and np.array_equal(view.numpy(), a[reg])
        assert np.shares_memory(view.numpy(), a)      # a view, no copy
