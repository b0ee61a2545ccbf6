"""The paper's platform-independent memory hierarchy (§3.1), with the
H100's levels in place of the TPU presets.

``MemoryLevel`` is a copy of ``repro.core.hierarchy.MemoryLevel``: the
fields ``size``, ``cacheLineSize``, ``siblings`` and ``child`` of the
paper's Listing 1, plus a ``name``, with the same JSON schema, so a tree
one package writes the other reads.  ``read_linux_hierarchy`` is the
paper's proof-of-concept tool over a Linux host's ``/sys`` (the host's
caches, RAM on top), and ``paper_system_a``/``paper_system_i`` are the
paper's two evaluation machines.  ``h100_hierarchy`` builds one card's
tree, or a mesh's:

  DCN     with ``hosts > 1`` only: the network between hosts, one copy
          of the NVLINK domain per host; the decode walk places whole
          serving replicas there (``HierarchicalPlan.replicas()``)
  NVLINK  the interconnect level, over ``mesh_devices`` cards a host
          (default one); its child copy is one card's HBM, so the decode
          walk sizes the page pool from the HBM left after the weights,
          and ``dist.sharding`` the FSDP degree, as on the TPU mesh
  HBM     80 GB of HBM3 per card
  L2      50 MB, shared by all SMs
  SMEM    232,448 B a block may use, one copy per SM (132 SMs)
  REG     65,536 32-bit registers per SM
"""

from __future__ import annotations

import glob
import json
import os
import re
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

    def to_dict(self) -> dict:
        d: dict = {"siblings": self.siblings, "size": self.size}
        if self.cache_line_size is not None:
            d["cacheLineSize"] = self.cache_line_size
        if self.name:
            d["name"] = self.name
        d["child"] = self.child.to_dict() if self.child is not None else None
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "MemoryLevel":
        child = d.get("child")
        return cls(
            size=int(d["size"]),
            siblings=[list(map(int, s)) for s in d["siblings"]],
            cache_line_size=(int(d["cacheLineSize"])
                             if d.get("cacheLineSize") else None),
            child=cls.from_dict(child) if child else None,
            name=d.get("name", ""),
        )

    @classmethod
    def from_json(cls, s: str) -> "MemoryLevel":
        return cls.from_dict(json.loads(s))

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

    @property
    def n_cores(self) -> int:
        return sum(len(s) for s in self.siblings) if self.siblings else 1

    def per_core_size(self) -> int:
        """TCL_PER_CORE of Algorithm 1: each core's share of one copy."""
        return self.size // max(1, self.cores_per_copy)

    def cache_levels(self) -> List["MemoryLevel"]:
        return [l for l in self.levels() if l.cache_line_size is not None]

    def llc(self) -> Optional["MemoryLevel"]:
        """Last Level Cache: the outermost cache level (paper §2.2.2)."""
        caches = self.cache_levels()
        return caches[0] if caches else None

    def lowest_shared_cache(self) -> Optional["MemoryLevel"]:
        """The innermost cache still shared by >1 core (paper §2.3)."""
        shared = [l for l in self.cache_levels() if l.cores_per_copy > 1]
        return shared[-1] if shared else self.llc()


def _parse_cpu_list(s: str) -> List[int]:
    """Parse a sysfs cpu list like ``0-3,8,10-11`` into ids."""
    out: List[int] = []
    for part in s.strip().split(","):
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def _parse_size(s: str) -> int:
    s = s.strip()
    m = re.match(r"^(\d+)\s*([KMG]?)B?$", s, re.IGNORECASE)
    if not m:
        return int(s)
    mult = {"": 1, "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3}[
        m.group(2).upper()]
    return int(m.group(1)) * mult


def read_linux_hierarchy(
        sysfs_root: str = "/sys/devices/system/cpu") -> MemoryLevel:
    """Build the hierarchy of a Linux host (paper §3.1).

    Walks ``cpuN/cache/indexM``, groups the entries by level and nests
    them RAM -> LLC -> ... -> L1d; instruction caches are skipped.  RAM's
    size is ``/proc/meminfo``'s ``MemTotal``.  A host whose sysfs has no
    cache entries (some VMs and containers) gives a tree that is RAM only.
    """
    cpu_dirs = sorted(
        glob.glob(os.path.join(sysfs_root, "cpu[0-9]*")),
        key=lambda p: int(re.search(r"cpu(\d+)$", p).group(1)),
    )
    if not cpu_dirs:
        raise FileNotFoundError(f"no cpus under {sysfs_root}")

    # level -> {"size": int, "line": int, "groups": {frozenset(cores)}}
    levels: dict = {}
    for cpu_dir in cpu_dirs:
        for idx in sorted(glob.glob(os.path.join(cpu_dir, "cache",
                                                 "index[0-9]*"))):
            def rd(fname: str) -> str:
                try:
                    with open(os.path.join(idx, fname)) as f:
                        return f.read().strip()
                except OSError:
                    return ""

            if rd("type") == "Instruction":
                continue
            lvl = int(rd("level") or 0)
            if lvl == 0:
                continue
            entry = levels.setdefault(
                lvl,
                {"size": _parse_size(rd("size") or "0"),
                 "line": int(rd("coherency_line_size") or 64),
                 "groups": set()},
            )
            shared = rd("shared_cpu_list")
            if shared:
                entry["groups"].add(frozenset(_parse_cpu_list(shared)))

    all_cores = sorted(
        int(re.search(r"cpu(\d+)$", p).group(1)) for p in cpu_dirs)

    ram_bytes = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    ram_bytes = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass

    child: Optional[MemoryLevel] = None
    for lvl in sorted(levels):  # L1 innermost first
        e = levels[lvl]
        siblings = (sorted([sorted(g) for g in e["groups"]])
                    or [[c] for c in all_cores])
        child = MemoryLevel(
            size=e["size"], siblings=siblings, cache_line_size=e["line"],
            child=child, name=f"L{lvl}",
        )
    return MemoryLevel(
        size=ram_bytes or (1 << 33), siblings=[all_cores],
        cache_line_size=None, child=child, name="RAM",
    )


def paper_system_a() -> MemoryLevel:
    """System A of the paper §4.1: 2x quad-core AMD Opteron 2376.

    64 KiB L1d / core, 512 KiB L2 / core, 6 MiB L3 / processor.
    """
    cores = list(range(8))
    groups = [cores[:4], cores[4:]]
    per_core = [[c] for c in cores]
    l1 = MemoryLevel(64 * 1024, per_core, 64, None, "L1")
    l2 = MemoryLevel(512 * 1024, per_core, 64, l1, "L2")
    l3 = MemoryLevel(6 * 1024 * 1024, groups, 64, l2, "L3")
    return MemoryLevel(8 << 30, [cores], None, l3, "RAM")


def paper_system_i() -> MemoryLevel:
    """System I of the paper §4.1: 2x dual-core hyperthreaded Intel Xeon.

    32 KiB L1d / core, 256 KiB L2 / core, 8 MiB L3 / processor; two
    hardware threads a core, so 8 workers over 4 physical cores.
    """
    cores = list(range(8))  # hardware threads
    per_core = [[0, 1], [2, 3], [4, 5], [6, 7]]  # HT pairs share L1/L2
    groups = [cores[:4], cores[4:]]
    l1 = MemoryLevel(32 * 1024, per_core, 64, None, "L1")
    l2 = MemoryLevel(256 * 1024, per_core, 64, l1, "L2")
    l3 = MemoryLevel(8 * 1024 * 1024, groups, 64, l2, "L3")
    return MemoryLevel(8 << 30, [cores], None, l3, "RAM")


def h100_hierarchy(
    hbm_bytes: int,
    smem_bytes: int,
    l2_bytes: int,
    n_sms: int = 132,
    reg_bytes: int = 65536 * 4,
    line_bytes: int = 128,
    hosts: int = 1,
    mesh_devices: int = 0,
) -> MemoryLevel:
    """One H100, or a mesh of them, in the paper's schema.

    The "cores" below the card level are SMs: each SM owns one copy of the
    shared-memory and register levels, and all SMs share the L2.  The
    access granule of L2 and shared memory is one 128 B line (32 banks of
    4 B); the sharding granule at the NVLINK level is read off the first
    level below HBM that has one.

    ``mesh_devices`` is the counterpart of the reference's
    ``tpu_hierarchy(mesh_devices=)``: the NVLINK level spans that many
    cards a host, each card's HBM one copy of its target level.  The
    default (0) is one card a host.  With ``hosts > 1`` a ``DCN`` level
    goes on top, as the reference's puts one above its ICI: each host's
    NVLINK domain is one copy of the DCN's target level, the NVLINK
    level's ``siblings`` group the global card ids by host, and the DCN
    level is ``hosts`` NVLINK domains in size.
    """
    sms = list(range(n_sms))
    per_sm = [[c] for c in sms]
    reg = MemoryLevel(reg_bytes, per_sm, 4, None, "REG")
    smem = MemoryLevel(smem_bytes, per_sm, line_bytes, reg, "SMEM")
    l2 = MemoryLevel(l2_bytes, [sms], line_bytes, smem, "L2")
    hosts = max(1, hosts)
    per_host = max(1, mesh_devices)
    cards = list(range(hosts * per_host))
    hbm = MemoryLevel(hbm_bytes, [[c] for c in cards], None, l2, "HBM")
    nvlink = MemoryLevel(per_host * hbm_bytes,
                         [cards[h * per_host:(h + 1) * per_host]
                          for h in range(hosts)], None, hbm, "NVLINK")
    if hosts <= 1:
        return nvlink
    return MemoryLevel(hosts * nvlink.size, [cards], None, nvlink, "DCN")
