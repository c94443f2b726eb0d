"""The Shanghai radar HDF5 dataset (port of ``kmunet_tpu/data/shanghai.py``).

- File layout (Shanghai.py:26,45-46): ``f['train'|'test']['all_len']`` a
  scalar, and one dataset per string index, each (25, 565, 784) uint8.
- Per item: ``frames / 255`` resized (antialiased bilinear) to (img_size,
  img_size); items are (25, S, S) float32, without the reference's channel
  axis of 1, which its training scripts squeeze away.
- A contiguous 60/20/20 train/val/test split of the 'train' group
  (train_shanghai.py:357-362).

h5py is imported only when a file is opened: the machine with the card has
none, and the synthetic data needs none.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from kmunet_tpu_torch.data.resize import Resizer

PIXEL_SCALE = 90.0
THRESHOLDS = [20, 30, 35, 40]

# The 16-colour radar colour map and its bounds (Shanghai.py:54-74), for utils/vis.py.
COLOR_MAP = np.array(
    [
        [0, 0, 0, 0], [0, 236, 236, 255], [1, 160, 246, 255], [1, 0, 246, 255],
        [0, 239, 0, 255], [0, 200, 0, 255], [0, 144, 0, 255], [255, 255, 0, 255],
        [231, 192, 0, 255], [255, 144, 2, 255], [255, 0, 0, 255], [166, 0, 0, 255],
        [101, 0, 0, 255], [255, 0, 255, 255], [153, 85, 201, 255], [255, 255, 255, 255],
    ]
) / 255.0
BOUNDS = [0, 5, 10, 15, 20, 25, 30, 35, 40, 45, 50, 55, 60, 65, 70, 75, PIXEL_SCALE]


def split_indices(n: int, fractions=(0.6, 0.8)) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous 60/20/20 split of range(n) (train_shanghai.py:357-362)."""
    idx = np.arange(n)
    a = math.floor(n * fractions[0])
    b = math.floor(n * fractions[1])
    return idx[:a], idx[a:b], idx[b:]


class ShanghaiDataset:
    """Indexable dataset of (25, S, S) float32 frame stacks, read through one
    open file handle."""

    def __init__(self, data_path: str, img_size: int = 256, group: str = "train",
                 indices: Sequence[int] | None = None, native_hw: tuple[int, int] = (565, 784)):
        import h5py

        assert group in ("train", "test", "val")
        self.group = group if group != "val" else "test"
        self._file = h5py.File(data_path, "r")
        self._grp = self._file[self.group]
        self.all_len = int(self._grp["all_len"][()])
        self.indices = np.asarray(indices) if indices is not None else np.arange(self.all_len)
        self.img_size = img_size
        self._resize = Resizer(native_hw, (img_size, img_size))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int) -> np.ndarray:
        raw = self._grp[str(int(self.indices[i]))][()]  # (25, H, W) uint8
        # The native core folds /255 into the resize; numpy does it first.
        y = self._resize.resize_scaled(raw, 1.0 / 255.0)
        if y is None:
            y = self._resize(raw.astype(np.float32) / 255.0)
        return y.astype(np.float32, copy=False)

    def close(self):
        self._file.close()
