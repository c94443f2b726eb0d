"""Determinism helpers (port of ``kmunet_tpu/utils/seed.py``; the
reference's models/utils.py:13-25 ``set_seed``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> None:
    """Seeds Python's ``random``, numpy's global generator, ``PYTHONHASHSEED``
    and torch's global generator (every device's). The port's own randomness
    (initialisation, DropPath, the loaders' order) draws from generators its
    callers seed; this covers the rest."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
