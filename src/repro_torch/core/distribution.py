"""The paper's ``Distribution`` interface (Table 1) and its distributions:
the two the decode planner uses, the row-block and square-block ones, the
stencil, and the Fig. 3 matmul domain and task grid (a copy of
``repro.core.distribution``).

A partition is an index region, a tuple of ``slice``s: it indexes a numpy
array or a torch tensor alike, and nothing is copied.

``validate(np)`` follows the paper's tri-state contract:
  < 0  -- no solution exists for any value >= np
  = 0  -- np is not a valid solution, but larger values may be
  > 0  -- np is a valid solution
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple


class Distribution:
    """Paper Table 1. Subclasses implement one sub-domain's decomposition."""

    def validate(self, np_: int) -> int:
        raise NotImplementedError

    def get_element_size(self) -> int:
        raise NotImplementedError

    def get_indivisible_size(self, np_: int) -> int:
        return 1

    def get_average_partition_size(self, np_: int) -> float:
        raise NotImplementedError

    def get_average_first_dim_size(self, np_: int) -> float:
        # Paper footnote 2: default for non-multidimensional structures.
        return 1.0

    def partition(self, np_: int) -> List[Tuple[slice, ...]]:
        """Split the domain into ``np_`` index regions (tuples of slices)."""
        raise NotImplementedError

    @property
    def total_elements(self) -> int:
        raise NotImplementedError


def _split_counts(total: int, parts: int) -> List[int]:
    """Sizes of ``parts`` near-equal chunks; the first ``total % parts``
    get one extra unit (paper §2.1: an unbalance of at most one
    indivisible unit)."""
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def _split_slices(total: int, parts: int) -> List[slice]:
    out, off = [], 0
    for c in _split_counts(total, parts):
        out.append(slice(off, off + c))
        off += c
    return out


@dataclass
class Array1DDistribution(Distribution):
    """Contiguous split of a 1-D domain (a KV token range, a byte range)."""

    length: int
    element_size: int
    indivisible: int = 1

    def validate(self, np_: int) -> int:
        if np_ <= 0:
            return 0
        units = self.length // self.indivisible
        return 1 if np_ <= units else -1

    def get_element_size(self) -> int:
        return self.element_size

    def get_indivisible_size(self, np_: int) -> int:
        return self.indivisible

    def get_average_partition_size(self, np_: int) -> float:
        return self.length / np_

    def get_average_first_dim_size(self, np_: int) -> float:
        return self.length / np_  # a 1-D partition is a single row

    def partition(self, np_: int) -> List[Tuple[slice, ...]]:
        units = self.length // self.indivisible
        return [(slice(s.start * self.indivisible,
                       min(s.stop * self.indivisible, self.length)),)
                for s in _split_slices(units, np_)]

    @property
    def total_elements(self) -> int:
        return self.length


@dataclass
class ReplicatedDistribution(Distribution):
    """A sub-domain pinned whole to every worker (weights, activations):
    partitioning the rest harder does not shrink it, so it adds a constant
    term to the phi footprint."""

    nbytes: int

    def validate(self, np_: int) -> int:
        return 1 if np_ >= 1 else 0

    def get_element_size(self) -> int:
        return 1

    def get_average_partition_size(self, np_: int) -> float:
        return float(self.nbytes)

    def partition(self, np_: int) -> List[Tuple[slice, ...]]:
        return [(slice(0, self.nbytes),) for _ in range(np_)]

    @property
    def total_elements(self) -> int:
        return self.nbytes


@dataclass
class RowBlockDistribution(Distribution):
    """Horizontal slabs of whole rows of a 2-D row-major array (a K or V
    sequence of ``rows`` tokens by ``cols`` head dims)."""

    rows: int
    cols: int
    element_size: int

    def validate(self, np_: int) -> int:
        if np_ <= 0:
            return 0
        return 1 if np_ <= self.rows else -1

    def get_element_size(self) -> int:
        return self.element_size

    def get_average_partition_size(self, np_: int) -> float:
        return self.rows * self.cols / np_

    def get_average_first_dim_size(self, np_: int) -> float:
        return float(self.cols)

    def partition(self, np_: int) -> List[Tuple[slice, ...]]:
        return [(s, slice(0, self.cols))
                for s in _split_slices(self.rows, np_)]

    @property
    def total_elements(self) -> int:
        return self.rows * self.cols


@dataclass
class Array2DBlockDistribution(Distribution):
    """Square-grid block decomposition of a 2-D array (paper Listing 2):
    ``validate`` admits only perfect squares, so the array splits into as
    many blocks per column as per row."""

    rows: int
    cols: int
    element_size: int

    def validate(self, np_: int) -> int:
        if np_ <= 0:
            return 0
        r = round(math.isqrt(np_))
        if r * r != np_:
            rnext = math.isqrt(np_) + 1
            if rnext > min(self.rows, self.cols):
                return -1
            return 0
        if r > min(self.rows, self.cols):
            return -1
        return 1

    def get_element_size(self) -> int:
        return self.element_size

    def get_average_partition_size(self, np_: int) -> float:
        r = round(math.sqrt(np_))
        return (self.rows * self.cols) / float(r * r)

    def get_average_first_dim_size(self, np_: int) -> float:
        # Row-major: a block's contiguous dim is its column extent.
        return self.cols / round(math.sqrt(np_))

    def partition(self, np_: int) -> List[Tuple[slice, ...]]:
        r = round(math.sqrt(np_))
        return [(rs, cs) for rs in _split_slices(self.rows, r)
                for cs in _split_slices(self.cols, r)]

    @property
    def total_elements(self) -> int:
        return self.rows * self.cols


@dataclass
class StencilDistribution(Distribution):
    """Block decomposition with neighbourhood constraints (paper §2.1).

    For a radius-``halo`` stencil each partition spans at least
    ``2*halo + 1`` elements per dimension (the paper's 3x3 example has
    halo=1).  Partitions are blocks of the interior; ``halo_region`` gives
    a block's halo-extended read region.
    """

    rows: int
    cols: int
    element_size: int
    halo: int = 1

    def _min_side(self) -> int:
        return 2 * self.halo + 1

    def validate(self, np_: int) -> int:
        if np_ <= 0:
            return 0
        r = round(math.isqrt(np_))
        if r * r != np_:
            rnext = math.isqrt(np_) + 1
            if (self.rows // rnext) < self._min_side() \
                    or (self.cols // rnext) < self._min_side():
                return -1
            return 0
        if (self.rows // r) < self._min_side() \
                or (self.cols // r) < self._min_side():
            return -1
        return 1

    def get_element_size(self) -> int:
        return self.element_size

    def get_indivisible_size(self, np_: int) -> int:
        return self._min_side()

    def get_average_partition_size(self, np_: int) -> float:
        # A partition's working set includes its halo ring.
        r = round(math.sqrt(np_))
        return ((self.rows / r + 2 * self.halo)
                * (self.cols / r + 2 * self.halo))

    def get_average_first_dim_size(self, np_: int) -> float:
        return self.cols / round(math.sqrt(np_)) + 2 * self.halo

    def partition(self, np_: int) -> List[Tuple[slice, ...]]:
        r = round(math.sqrt(np_))
        return [(rs, cs) for rs in _split_slices(self.rows, r)
                for cs in _split_slices(self.cols, r)]

    def halo_region(self, region: Tuple[slice, ...]) -> Tuple[slice, ...]:
        rs, cs = region
        return (
            slice(max(0, rs.start - self.halo),
                  min(self.rows, rs.stop + self.halo)),
            slice(max(0, cs.start - self.halo),
                  min(self.cols, cs.stop + self.halo)),
        )

    @property
    def total_elements(self) -> int:
        return self.rows * self.cols


@dataclass
class CompositeDomain:
    """A domain built from sub-domains, each with its own distribution
    (paper §2.1); one partition of it is one partition of each."""

    dists: Sequence[Distribution]

    def __iter__(self):
        return iter(self.dists)

    def __len__(self):
        return len(self.dists)


def matmul_domain(n: int, m: int, k: int,
                  element_size: int) -> CompositeDomain:
    """The paper's Fig. 3 decomposition of C[n,m] = A[n,k] @ B[k,m]: three
    square-blocked sub-domains (A, B and C)."""
    return CompositeDomain(dists=[
        Array2DBlockDistribution(n, k, element_size),   # A
        Array2DBlockDistribution(k, m, element_size),   # B
        Array2DBlockDistribution(n, m, element_size),   # C
    ])


def matmul_task_grid(np_: int) -> List[Tuple[int, int, int]]:
    """Tasks of the Fig. 3 blocked matmul: each C block (i, j) meets the
    sqrt(np) (A, B) block pairs along k, so sqrt(np)^3 tasks, k innermost
    (the paper's 1024^2 example with 16x16 blocks has 4096)."""
    side = round(math.sqrt(np_))
    return [(i, j, kk) for i in range(side) for j in range(side)
            for kk in range(side)]
