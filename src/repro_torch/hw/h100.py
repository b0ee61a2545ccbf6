"""NVIDIA H100 SXM specification: the port's counterpart of
``repro.hw.tpu.TPUSpec`` / ``chip_spec``.

Numbers are NVIDIA's published ones for the SXM part (data sheet and the
Hopper architecture white paper): 132 SMs, 232,448 B of shared memory a
block may use, 65,536 registers per SM, 50 MB of L2, 80 GB of HBM3 at
3.35 TB/s, 989 TFLOP/s dense bf16 and 67 TFLOP/s float32 outside the
tensor cores.  They assume the full 700 W power limit.
``h100_spec(**overrides)`` replaces fields, e.g. a tiny ``smem_bytes`` so
that tests see many small pages.

Alignment granules, in place of the TPU's (``repro.hw.tpu``):

  ``mma_rows`` (64)          replaces ``mxu`` (128): ``wgmma`` issues a
                             64-row tile, so an M or N block extent larger
                             than one tile is a whole number of them.
  ``mma_depth(dtype_bytes)`` replaces ``sublane(dtype_bytes)`` (8/16/32
                             rows): ``wgmma``'s depth is 32 bytes (16 bf16
                             values, 8 float32), so a reduction extent (a
                             matmul's K block, attention's KV block) is a
                             whole number of steps.
  ``vec_bytes`` (16)         replaces ``lane`` (128 elements) as the
                             padding of a tile's contiguous dim: a thread
                             loads 16 bytes at a time, so a staged row
                             occupies whole 16-byte vectors.
  ``smem_line_bytes`` (128)  the shared-memory line (32 banks of 4 B): the
                             access granule of the SMEM level, the
                             ``cache_line_size`` Algorithm 1 is given.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.hierarchy import MemoryLevel, h100_hierarchy


@dataclass(frozen=True)
class H100Spec:
    name: str = "h100_sxm"
    peak_bf16_flops: float = 989e12     # FLOP/s, dense, tensor cores
    peak_f32_flops: float = 67e12       # FLOP/s, CUDA cores
    hbm_bytes: int = 80 * 10**9
    hbm_bw: float = 3.35e12             # bytes/s
    l2_bytes: int = 50 * 10**6
    smem_bytes: int = 232_448           # per block (opt-in maximum)
    num_sms: int = 132
    regs_per_sm: int = 65536            # 32-bit registers
    mma_rows: int = 64                  # wgmma tile rows
    mma_depth_bytes: int = 32           # wgmma depth: 16 bf16 values
    vec_bytes: int = 16                 # fastest per-thread load
    smem_line_bytes: int = 128          # 32 banks x 4 B

    def mma_depth(self, dtype_bytes: int) -> int:
        """Elements of one ``wgmma`` depth step: 16 bf16, 8 float32."""
        return max(1, self.mma_depth_bytes // max(1, dtype_bytes))

    def hierarchy(self) -> MemoryLevel:
        """This card in the paper's §3.1 schema:
        NVLINK -> HBM -> L2 -> SMEM -> REG."""
        return h100_hierarchy(
            hbm_bytes=self.hbm_bytes,
            smem_bytes=self.smem_bytes,
            l2_bytes=self.l2_bytes,
            n_sms=self.num_sms,
            reg_bytes=self.regs_per_sm * 4,
            line_bytes=self.smem_line_bytes,
        )


H100_SXM = H100Spec()


def h100_spec(**overrides) -> H100Spec:
    return replace(H100_SXM, **overrides) if overrides else H100_SXM
