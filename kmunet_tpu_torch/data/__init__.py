"""Data of the port."""

from kmunet_tpu_torch.data.synthetic import SyntheticNowcastDataset

__all__ = ["SyntheticNowcastDataset"]
