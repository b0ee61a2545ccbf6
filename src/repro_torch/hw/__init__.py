from repro_torch.hw.h100 import H100_SXM, H100Spec, h100_spec

__all__ = ["H100_SXM", "H100Spec", "h100_spec"]
