"""Antialiased bilinear resize on the host (port of
``kmunet_tpu/data/resize.py``).

The reference resizes (25, 565, 784) uint8 frame stacks with torchvision's
``transforms.Resize`` (Shanghai.py:31-33), bilinear with antialias: a
triangle (tent) filter whose support scales with the downsampling ratio,
window clipped to the image and renormalized, as PIL computes its weights.
Separable: one (out, in) weight matrix per axis, applied by the native core
in banded form (``data/native.py``), or as two dense matmuls in numpy where
no toolchain is present.
"""

from __future__ import annotations

import numpy as np

from kmunet_tpu_torch.data import native


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) antialiased bilinear weight matrix, PIL's."""
    scale = max(in_size / out_size, 1.0)
    step = in_size / out_size
    support = scale  # the bilinear filter's support 1.0, times scale
    W = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * step
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        idx = np.arange(xmin, xmax)
        w = np.clip(1.0 - np.abs((idx + 0.5 - center) / scale), 0.0, None)
        s = w.sum()
        if s > 0:
            W[i, xmin:xmax] = w / s
    return W


class Resizer:
    """The weight matrices of one (in, out) shape pair, kept; two paths of
    the same arithmetic: the native core (banded; ``resize_scaled`` also
    folds a value scale, such as the reference's frames/255, into the row
    taps) and numpy's dense two-matmul einsum."""

    def __init__(self, in_hw: tuple[int, int], out_hw: tuple[int, int]):
        self.in_hw = in_hw
        self.out_hw = out_hw
        self._wh = _triangle_weights(in_hw[0], out_hw[0]).astype(np.float32)
        self._ww = _triangle_weights(in_hw[1], out_hw[1]).astype(np.float32).T
        self._banded: dict[float, tuple] = {}

    def _banded_weights(self, scale: float) -> tuple:
        """Banded (row, col) weights with ``scale`` folded into the row taps."""
        if scale not in self._banded:
            wh, hs = native.to_banded(self._wh * np.float32(scale))
            ww, ws = native.to_banded(self._ww.T)
            self._banded[scale] = (wh, hs, ww, ws)
        return self._banded[scale]

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """(..., H, W) float frames -> (..., Ho, Wo)."""
        if frames.dtype == np.float32:
            y = self.resize_scaled(frames, 1.0)
            if y is not None:
                return y
        lead = frames.shape[:-2]
        x = frames.reshape(-1, *self.in_hw)
        y = np.einsum("oh,nhw,wp->nop", self._wh, x, self._ww, optimize=True)
        return y.reshape(*lead, *self.out_hw)

    def resize_scaled(self, frames: np.ndarray, scale: float):
        """The native core's scale-and-resize of uint8 or float32 frames;
        None without the library, or for frames of another shape."""
        if tuple(frames.shape[-2:]) != tuple(self.in_hw):
            return None
        return native.banded_resize(frames, *self._banded_weights(scale))


def resize_bilinear_antialias(frames: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    return Resizer(frames.shape[-2:], out_hw)(frames)
