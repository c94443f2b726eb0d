"""Inputs and fixtures of the port's tests that need neither JAX nor a card,
so that the ``gpu`` tests can run on a machine without JAX."""

import numpy as np
import pytest
import torch


def coordinate_cases(rng, B, H, W, Ho, Wo):
    """Named (x, y) pixel-coordinate fields, (B, Ho, Wo) float32 each."""
    shape = (B, Ho, Wo)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    jj = np.broadcast_to(np.arange(Wo) % W, shape)
    ii = np.broadcast_to((np.arange(Ho) % H)[:, None], shape)
    return {
        "spread": (f32(rng.uniform(-1.5, W + 0.5, shape)), f32(rng.uniform(-1.5, H + 0.5, shape))),
        "integer": (f32(rng.integers(-1, W + 1, shape)), f32(rng.integers(-1, H + 1, shape))),
        "last_pixel": (f32(np.full(shape, W - 1)), f32(np.full(shape, H - 1))),
        "grid": (f32(jj), f32(ii)),
        "far_outside": (
            f32(np.where(rng.uniform(size=shape) < 0.5, -2.0 - rng.uniform(0, 9, shape),
                         W + 1.0 + rng.uniform(0, 9, shape))),
            f32(np.where(rng.uniform(size=shape) < 0.5, -1e6, H + 1e3 * rng.uniform(size=shape))),
        ),
    }


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; skips where there is none. Decided
    inside the fixture so that every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


GATHER_SHAPES = {"bridge": (2, 16, 16, 64), "ragged": (3, 7, 9, 24)}
GATHER_CASES = ("spread", "integer", "last_pixel", "grid", "far_outside")


def gather_inputs(shape, case, seed=0):
    """img (B, H, W, C) and one coordinate case at (B, H+1, W-2), numpy fp32."""
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    img = rng.normal(size=shape).astype(np.float32)
    x, y = coordinate_cases(rng, B, H, W, H + 1, W - 2)[case]
    return img, x, y
