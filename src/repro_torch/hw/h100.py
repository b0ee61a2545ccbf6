"""NVIDIA H100 SXM specification: the port's counterpart of
``repro.hw.tpu.TPUSpec`` / ``chip_spec``.

Numbers are NVIDIA's published ones for the SXM part (data sheet and the
Hopper architecture white paper): 132 SMs, 232,448 B of shared memory a
block may use, 65,536 registers per SM, 50 MB of L2, 80 GB of HBM3 at
3.35 TB/s, 989 TFLOP/s dense bf16 and 67 TFLOP/s float32 outside the
tensor cores.  They assume the full 700 W power limit.
``h100_spec(**overrides)`` replaces fields, e.g. a tiny ``smem_bytes`` so
that tests see many small pages.
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

    def hierarchy(self) -> MemoryLevel:
        """This card in the paper's §3.1 schema:
        NVLINK -> HBM -> L2 -> SMEM -> REG."""
        return h100_hierarchy(
            hbm_bytes=self.hbm_bytes,
            smem_bytes=self.smem_bytes,
            l2_bytes=self.l2_bytes,
            n_sms=self.num_sms,
            reg_bytes=self.regs_per_sm * 4,
        )


H100_SXM = H100Spec()


def h100_spec(**overrides) -> H100Spec:
    return replace(H100_SXM, **overrides) if overrides else H100_SXM
