"""The paper's platform-independent memory hierarchy (§3.1), with the
H100's levels in place of the TPU presets.

``MemoryLevel`` is a copy of ``repro.core.hierarchy.MemoryLevel`` (fields
``size``, ``cacheLineSize``, ``siblings``, ``child`` of the paper's
Listing 1, plus a ``name``).  ``h100_hierarchy`` builds one card's tree:

  NVLINK  the interconnect level, over one card; its child copy is the
          card's HBM, so the decode walk sizes the page pool from the HBM
          left after the weights, as on the TPU mesh
  HBM     80 GB of HBM3 per card
  L2      50 MB, shared by all SMs
  SMEM    232,448 B a block may use, one copy per SM (132 SMs)
  REG     65,536 32-bit registers per SM
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional


@dataclass
class MemoryLevel:
    """One level of the hierarchy (paper §3.1).

    Attributes:
      size: size in bytes of each individual memory element at this level.
      cache_line_size: coherence-line (or access-granule) size in bytes;
        None for levels without one (HBM, the interconnect).
      siblings: array of arrays of sibling core ids sharing each copy.
      child: the lower (closer-to-core) level, or None at the bottom.
      name: the level's tag; the planner classifies levels by it.
    """

    size: int
    siblings: List[List[int]]
    cache_line_size: Optional[int] = None
    child: Optional["MemoryLevel"] = None
    name: str = ""

    def levels(self) -> Iterator["MemoryLevel"]:
        """Iterate from this (outermost) level down to the innermost."""
        lvl: Optional[MemoryLevel] = self
        while lvl is not None:
            yield lvl
            lvl = lvl.child

    def find(self, name: str) -> Optional["MemoryLevel"]:
        for lvl in self.levels():
            if lvl.name == name:
                return lvl
        return None

    @property
    def cores_per_copy(self) -> int:
        """Number of cores sharing each copy of this level."""
        if not self.siblings:
            return 1
        return max(len(s) for s in self.siblings)

    def per_core_size(self) -> int:
        """TCL_PER_CORE of Algorithm 1: each core's share of one copy."""
        return self.size // max(1, self.cores_per_copy)


def h100_hierarchy(
    hbm_bytes: int,
    smem_bytes: int,
    l2_bytes: int,
    n_sms: int = 132,
    reg_bytes: int = 65536 * 4,
    line_bytes: int = 128,
) -> MemoryLevel:
    """One H100 in the paper's schema.

    The "cores" below the card level are SMs: each SM owns one copy of the
    shared-memory and register levels, and all SMs share the L2.  The
    access granule of L2 and shared memory is one 128 B line (32 banks of
    4 B); the sharding granule at the NVLINK level is read off the first
    level below HBM that has one.
    """
    sms = list(range(n_sms))
    per_sm = [[c] for c in sms]
    reg = MemoryLevel(reg_bytes, per_sm, 4, None, "REG")
    smem = MemoryLevel(smem_bytes, per_sm, line_bytes, reg, "SMEM")
    l2 = MemoryLevel(l2_bytes, [sms], line_bytes, smem, "L2")
    hbm = MemoryLevel(hbm_bytes, [[0]], None, l2, "HBM")
    return MemoryLevel(hbm_bytes, [[0]], None, hbm, "NVLINK")
