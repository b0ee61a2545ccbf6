"""The paper's ``Distribution`` interface (Table 1) and the two
distributions the decode planner uses (a copy of the matching part of
``repro.core.distribution``).

``validate(np)`` follows the paper's tri-state contract:
  < 0  -- no solution exists for any value >= np
  = 0  -- np is not a valid solution, but larger values may be
  > 0  -- np is a valid solution
"""

from __future__ import annotations

from dataclasses import dataclass


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
