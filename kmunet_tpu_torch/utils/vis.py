"""Radar visualization (port of ``kmunet_tpu/utils/vis.py``): the colour
map and tiled frame strips of the reference's ``vis_res`` / ``gray2color``
(train_shanghai.py:36-154): normalized frames rescaled by PIXEL_SCALE,
coloured with the 16-colour radar map by BOUNDS bins, tiled horizontally
with 10-px white gaps, and saved as prediction / gt / input PNGs; and the
NC scripts' per-frame PNGs (``vis_channels``).

matplotlib is imported only where a PNG is written: the machine with the
card has none.
"""

from __future__ import annotations

import os

import numpy as np

from kmunet_tpu_torch.data.shanghai import BOUNDS, COLOR_MAP, PIXEL_SCALE


def gray2color(image: np.ndarray) -> np.ndarray:
    """(H, W) radar intensities -> (H, W, 4) RGBA by BOUNDS bins."""
    bins = np.digitize(image, BOUNDS[1:-1], right=False)  # 0..15
    return COLOR_MAP[np.clip(bins, 0, len(COLOR_MAP) - 1)]


def tile_frames(frames: np.ndarray, gap: int = 10, subsample_even: bool = False) -> np.ndarray:
    """(T, H, W) normalized frames -> one (H, T*(W+gap)-gap, 4) RGBA strip."""
    if subsample_even:
        frames = frames[::2]
    frames = np.clip(frames, 0.0, 1.0) * PIXEL_SCALE
    colored = [gray2color(f) for f in frames]
    T = len(colored)
    H, W, C = colored[0].shape
    strip = np.ones((H, T * W + gap * (T - 1), C), np.float64)
    for i, img in enumerate(colored):
        x0 = i * (W + gap)
        strip[:, x0:x0 + W] = img
    return strip


def vis_channels(arr, save_path: str, prefix: str = "", cmap: str = "viridis"):
    """Per-frame PNGs with a colour bar, ``{prefix}ch{t}.png`` under
    ``save_path``: the NC scripts' visualization style
    (models/train_NC_mambaunet.py:120-186). ``arr``: (T, H, W) normalized."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    for t, frame in enumerate(np.asarray(arr)):
        fig, ax = plt.subplots()
        im = ax.imshow(frame, cmap=cmap)
        fig.colorbar(im, ax=ax)
        ax.axis("off")
        fig.savefig(os.path.join(save_path, f"{prefix}ch{t}.png"), bbox_inches="tight")
        plt.close(fig)


def vis_res(pred, gt, inp, save_path: str, prefix: str = "", subsample_even: bool = False):
    """Saves the prediction / gt / input strips of (T, H, W) normalized
    arrays as PNGs under ``save_path`` (matplotlib Agg, as the reference)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    for name, arr in [("prediction", pred), ("gt", gt), ("input", inp)]:
        if arr is None:
            continue
        strip = tile_frames(np.asarray(arr), subsample_even=subsample_even)
        fig, ax = plt.subplots(figsize=(strip.shape[1] / 100, strip.shape[0] / 100), dpi=100)
        ax.imshow(strip)
        ax.axis("off")
        fig.savefig(os.path.join(save_path, f"{prefix}{name}.png"), bbox_inches="tight",
                    pad_inches=0)
        plt.close(fig)
