"""The LAPS / "NC" dataset (port of ``kmunet_tpu/data/laps.py``): sliding
windows over an HDF5 ``vil`` array (train_LAPS.py:394-421).

``h5['vil']`` (N, H, W) -> every contiguous window of ``group_size`` = 8
frames -> an 80/10/10 contiguous split of the windows; training slices each
into 5 input and 3 target frames (train_LAPS.py:163-164).
"""

from __future__ import annotations

import numpy as np


class LAPSDataset:
    """Indexable dataset of (group_size, H, W) float32 windows, of the file
    at ``data_path`` or of the array ``vil``."""

    def __init__(self, data_path: str | None = None, group_size: int = 8, split: str = "train",
                 vil: np.ndarray | None = None, fractions=(0.8, 0.9)):
        if vil is None:
            import h5py

            with h5py.File(data_path, "r") as f:
                vil = f["vil"][()]
        self.vil = np.asarray(vil, dtype=np.float32)
        n_windows = self.vil.shape[0] - group_size + 1
        starts = np.arange(n_windows)
        a = int(n_windows * fractions[0])
        b = int(n_windows * fractions[1])
        self.starts = {"train": starts[:a], "val": starts[a:b], "test": starts[b:]}[split]
        self.group_size = group_size

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.vil[s:s + self.group_size]
