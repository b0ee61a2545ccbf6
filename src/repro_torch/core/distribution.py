"""The paper's ``Distribution`` interface (Table 1), the two distributions
the decode planner uses, and the row-block and square-block distributions
and the Fig. 3 matmul domain the tile planner searches (a copy of the
matching part of ``repro.core.distribution``; the ``partition`` methods
and the stencil distribution wait for the host-cache engine).

``validate(np)`` follows the paper's tri-state contract:
  < 0  -- no solution exists for any value >= np
  = 0  -- np is not a valid solution, but larger values may be
  > 0  -- np is a valid solution
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


class Distribution:
    """Paper Table 1. Subclasses implement one sub-domain's decomposition."""

    def validate(self, np_: int) -> int:
        raise NotImplementedError

    def get_element_size(self) -> int:
        raise NotImplementedError

    def get_average_partition_size(self, np_: int) -> float:
        raise NotImplementedError

    def get_average_first_dim_size(self, np_: int) -> float:
        # Paper footnote 2: default for non-multidimensional structures.
        return 1.0


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

    def get_average_partition_size(self, np_: int) -> float:
        return self.length / np_

    def get_average_first_dim_size(self, np_: int) -> float:
        return self.length / np_  # a 1-D partition is a single row


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
