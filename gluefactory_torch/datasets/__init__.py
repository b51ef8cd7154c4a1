from .base_dataset import BaseDataset, get_dataset

__all__ = ["BaseDataset", "get_dataset"]
