"""Tensor ops of the port against the JAX package, fp32 on the CPU.

Tolerance 1e-5 abs unless a test says otherwise: the two sides do the same
arithmetic at these small shapes, in orders that differ by a few roundings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.ops import dwt as dwt_jax
from kmunet_tpu.ops import sample as sample_jax
from kmunet_tpu.ops import spline as spline_jax
from kmunet_tpu_torch.ops import dwt, sample, spline
from tests.torch_parity import nchw, nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-5


def test_cardinal_basis_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.6, 1.6, (2, 5, 6, 3)).astype(np.float32)
    x[0, 0, :, 0] = np.linspace(-1.0, 1.0, 6)  # knots: the half-open intervals
    want = np.asarray(spline_jax.cardinal_bspline_basis_flat(jnp.asarray(x)))
    got = nhwc(spline.cardinal_bspline_basis_flat(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_cox_de_boor_basis_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, (7, 4)).astype(np.float32)
    grid = np.array(spline_jax.make_uniform_grid(4))
    want = np.asarray(spline_jax.bspline_basis(jnp.asarray(x), jnp.asarray(grid)))
    got = spline.bspline_basis(torch.from_numpy(x), torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(spline.knots().numpy(), grid[0], rtol=0, atol=1e-7)


@pytest.mark.parametrize("quirk", [True, False])
def test_haar_dwt_matches_jax(quirk):
    x = np.random.default_rng(2).normal(size=(2, 6, 8, 3)).astype(np.float32)
    want = dwt_jax.haar_dwt2d(jnp.asarray(x), quirk_edge_zero=quirk)
    got = dwt.haar_dwt2d(nchw(x), quirk_edge_zero=quirk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(12, 10), (3, 4)])
def test_resize_bilinear_matches_jax(size, align_corners):
    x = np.random.default_rng(3).normal(size=(2, 6, 5, 3)).astype(np.float32)
    want = sample_jax.resize_bilinear(jnp.asarray(x), size, align_corners=align_corners)
    got = sample.resize_bilinear(nchw(x), size, align_corners=align_corners)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("spread", [0.6, 3.0])
def test_dysample_window_upsample_matches_jax(spread):
    """``spread`` 3.0 drives offsets past the window radius 2: both sides clamp."""
    rng = np.random.default_rng(4)
    B, h, w, C, s, G = 2, 5, 5, 8, 2, 4
    x = rng.normal(size=(B, h, w, C)).astype(np.float32)
    ex = rng.uniform(-spread, spread, (B, h, w, s, s, G)).astype(np.float32)
    ey = rng.uniform(-spread, spread, (B, h, w, s, s, G)).astype(np.float32)
    want = sample_jax.dysample_window_upsample(jnp.asarray(x), jnp.asarray(ex), jnp.asarray(ey))
    # the port's offsets are (B, G, s, s, h, w)
    to_port = lambda e: torch.from_numpy(np.ascontiguousarray(e.transpose(0, 5, 3, 4, 1, 2)))  # noqa: E731
    got = sample.dysample_window_upsample(nchw(x), to_port(ex), to_port(ey))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=ATOL)
