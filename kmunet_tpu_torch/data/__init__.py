"""Data of the port: the datasets, the resize and the loader."""

from kmunet_tpu_torch.data.laps import LAPSDataset
from kmunet_tpu_torch.data.pipeline import DataLoader
from kmunet_tpu_torch.data.shanghai import PIXEL_SCALE, THRESHOLDS, ShanghaiDataset, split_indices
from kmunet_tpu_torch.data.synthetic import SyntheticNowcastDataset

__all__ = ["DataLoader", "LAPSDataset", "PIXEL_SCALE", "ShanghaiDataset",
           "SyntheticNowcastDataset", "THRESHOLDS", "split_indices"]
