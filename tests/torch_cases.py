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


# (B, H, W, C, G, Ho, Wo): one coordinate set per channel group of C/G
# channels. Cg = 6 and 3 take no 16-byte vector in fp32 (one channel per
# thread on the card); "dysample" is DySample's 2x layout (Cg = 16).
GROUPED_SHAPES = {
    "g1_cg6": (2, 7, 9, 6, 1, 8, 7),
    "g2_cg3": (2, 7, 9, 6, 2, 8, 7),
    "g4_cg6": (2, 7, 9, 24, 4, 8, 7),
    "dysample": (1, 8, 8, 64, 4, 16, 16),
}


def grouped_inputs(shape, case, seed=0):
    """img (B, H, W, C), the coordinate case drawn for every group, x and y
    (B, G, Ho, Wo), and an upstream gradient (B, Ho, Wo, C), numpy fp32."""
    B, H, W, C, G, Ho, Wo = shape
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    x, y = coordinate_cases(rng, B * G, H, W, Ho, Wo)[case]
    g = rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)
    return img, x.reshape(B, G, Ho, Wo), y.reshape(B, G, Ho, Wo), g


# (B, H, W, C, G, Ho, Wo): one source of C channels sampled at G coordinate
# sets (TrajGRU's warp, K7). C = 3 and 6 take no 16-byte vector in fp32 (one
# channel per thread on the card).
MULTIVIEW_SHAPES = {
    "g1_c6": (2, 7, 9, 6, 1, 8, 7),
    "g3_c3": (2, 7, 9, 3, 3, 8, 7),
    "g3_c6": (2, 7, 9, 6, 3, 8, 7),
    "g3_c16": (1, 6, 5, 16, 3, 4, 4),
    "g13_c6": (2, 5, 6, 6, 13, 5, 6),
    "g13_c16": (1, 8, 8, 16, 13, 8, 8),
}


def multiview_inputs(shape, case, seed=0):
    """img (B, H, W, C), the coordinate case drawn for every view, x and y
    (B, G, Ho, Wo), and an upstream gradient (B, Ho, Wo, G*C), numpy fp32."""
    B, H, W, C, G, Ho, Wo = shape
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    x, y = coordinate_cases(rng, B * G, H, W, Ho, Wo)[case]
    g = rng.normal(size=(B, Ho, Wo, G * C)).astype(np.float32)
    return img, x.reshape(B, G, Ho, Wo), y.reshape(B, G, Ho, Wo), g


def shifted_views(img, shifts):
    """What the multiview gather returns at integer coordinates
    x = j - dx_l, y = i - dy_l for the (dy_l, dx_l) in ``shifts``: view l is
    ``img`` (B, H, W, C) shifted by (dy_l, dx_l), zeros where it leaves the
    image -> (B, H, W, L*C), view l in channel block l; and those
    coordinates, (B, L, H, W) each."""
    B, H, W, C = img.shape
    out = np.zeros((B, H, W, len(shifts) * C), img.dtype)
    xs = np.zeros((B, len(shifts), H, W), np.float32)
    ys = np.zeros_like(xs)
    for v, (dy, dx) in enumerate(shifts):
        ys[:, v] = np.arange(H)[:, None] - dy
        xs[:, v] = np.arange(W)[None, :] - dx
        for i in range(H):
            for j in range(W):
                si, sj = i - dy, j - dx
                if 0 <= si < H and 0 <= sj < W:
                    out[:, i, j, v * C:(v + 1) * C] = img[:, si, sj]
    return out, xs, ys
