from repro_torch.data.pipeline import DataPipeline, SyntheticLMDataset

__all__ = ["DataPipeline", "SyntheticLMDataset"]
