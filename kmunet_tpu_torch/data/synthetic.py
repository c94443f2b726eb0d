"""Synthetic Shanghai-shaped nowcasting data: the port's own copy of
``kmunet_tpu/data/synthetic.py``, numpy only, with the same items for the
same seed.

Advecting Gaussian "storm cells": items are (seq_len, S, S) float32 in
[0, 1] with heavy-tail intensities, temporally coherent so that forecast
skill is learnable. An item is a function of (seed, i), so it is kept once
made: a loader's later epochs do not make it again.
"""

from __future__ import annotations

import numpy as np


class SyntheticNowcastDataset:
    def __init__(
        self,
        length: int = 64,
        img_size: int = 256,
        seq_len: int = 25,
        n_cells: int = 4,
        seed: int = 0,
    ):
        self.length = length
        self.img_size = img_size
        self.seq_len = seq_len
        self.n_cells = n_cells
        self.seed = seed
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache[i] = self._generate(i)
        return self._cache[i]

    def _generate(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + i)
        S, T, K = self.img_size, self.seq_len, self.n_cells
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)

        pos = rng.uniform(0.1 * S, 0.9 * S, (K, 2)).astype(np.float32)
        vel = rng.uniform(-0.01 * S, 0.01 * S, (K, 2)).astype(np.float32)
        sigma = rng.uniform(0.04 * S, 0.12 * S, K).astype(np.float32)
        amp = rng.uniform(0.3, 0.95, K).astype(np.float32)
        growth = rng.uniform(-0.01, 0.01, K).astype(np.float32)

        frames = np.zeros((T, S, S), np.float32)
        for t in range(T):
            for k in range(K):
                cy, cx = pos[k] + vel[k] * t
                a = amp[k] * (1.0 + growth[k] * t)
                g = a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma[k] ** 2))
                frames[t] += g
        return np.clip(frames, 0.0, 1.0)
