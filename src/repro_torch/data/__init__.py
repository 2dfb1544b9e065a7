from repro_torch.data.pipeline import DataConfig, MarkovTextDataset

__all__ = ["DataConfig", "MarkovTextDataset"]
