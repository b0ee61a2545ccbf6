from repro_torch.roofline.ops import OpSummary, analyze_ops
from repro_torch.roofline.report import RooflineTerms, roofline_terms

__all__ = ["OpSummary", "analyze_ops", "RooflineTerms", "roofline_terms"]
