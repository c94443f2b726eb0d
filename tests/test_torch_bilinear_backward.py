"""K6, the bilinear gather's backward, in the port against the JAX package.

The plain version (what the port runs on a CPU tensor) is held to ``jax.vjp``
of ``bilinear_gather_xla`` and to the Pallas backward in interpret mode (the
custom VJP of ``gather_bilinear_{zeros,border}``, which runs
``_backward_impl`` and chains the border clamp), fp32, zeros and border
modes, on the coordinate cases of tests/torch_cases.py (integer
coordinates, exact border edges, -1e6 and dim+1e3), within 1e-5 abs plus
1e-5 relative: ``d_img`` sums at most four terms per tap, but ``d_x`` and
``d_y`` are sums over C of products, taken in another order than JAX takes
them. ``BilinearGather`` on the CPU routes to the plain versions with no
kernel launch and passes ``torch.autograd.gradcheck`` in float64. The CUDA
kernel is held to the plain version on the card in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.kernels.bilinear_pallas import gather_bilinear_border, gather_bilinear_zeros
from kmunet_tpu.ops.sample import bilinear_gather_xla
from kmunet_tpu_torch.kernels import bilinear
from tests.torch_cases import GATHER_CASES as CASES
from tests.torch_cases import GATHER_SHAPES as SHAPES
from tests.torch_cases import gather_inputs
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = ("zeros", "border")
PALLAS = {"zeros": gather_bilinear_zeros, "border": gather_bilinear_border}
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, case, seed=0):
    img, x, y = gather_inputs(shape, case, seed)
    g = np.random.default_rng(seed + 100).normal(size=x.shape + (shape[-1],)).astype(np.float32)
    return img, x, y, g


def _plain(img, x, y, g, mode):
    grads = bilinear.bilinear_gather_backward_plain(
        *(torch.from_numpy(a) for a in (img, x, y, g)), mode)
    return [t.numpy() for t in grads]


def _jax_vjp(fn, img, x, y, g):
    _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _assert_grads(got, want):
    for name, a, b in zip(("d_img", "d_x", "d_y"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_backward_matches_xla_vjp(mode, shape, case):
    img, x, y, g = _inputs(SHAPES[shape], case)
    want = _jax_vjp(lambda i, a, b: bilinear_gather_xla(i, a, b, mode), img, x, y, g)
    _assert_grads(_plain(img, x, y, g, mode), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_backward_matches_pallas_interpret(mode, case):
    img, x, y, g = _inputs(SHAPES["ragged"], case, seed=1)
    want = _jax_vjp(lambda i, a, b: PALLAS[mode](i, a, b, True), img, x, y, g)
    _assert_grads(_plain(img, x, y, g, mode), want)


@pytest.mark.parametrize("mode", MODES)
def test_border_edge_gets_half_the_gradient(mode):
    """2x8x8x16, coordinates in [-2, 9], x exactly on 0 and 7 at two pixels:
    both JAX backwards and the plain version agree there, and in border mode
    JAX passes 0.5 of the gradient at x = 0 (``jnp.clip``'s VJP), where
    ``torch.clamp`` would pass all of it."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    x = rng.uniform(-2, 9, (2, 8, 8)).astype(np.float32)
    y = rng.uniform(-2, 9, (2, 8, 8)).astype(np.float32)
    x[0, 1, 2], x[1, 3, 4] = 0.0, 7.0
    g = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    got = _plain(img, x, y, g, mode)
    _assert_grads(got, _jax_vjp(lambda i, a, b: bilinear_gather_xla(i, a, b, mode), img, x, y, g))
    _assert_grads(got, _jax_vjp(lambda i, a, b: PALLAS[mode](i, a, b, True), img, x, y, g))
    if mode == "border":
        x_in = x.copy()
        x_in[0, 1, 2] = 1e-3  # just inside: the one-sided derivative in full
        inside = _plain(img, x_in, y, g, mode)[1][0, 1, 2]
        assert inside != 0.0
        np.testing.assert_allclose(got[1][0, 1, 2], 0.5 * inside, rtol=1e-2)
        assert got[1][1, 3, 4] == 0.0  # x0 on the last pixel


def test_cpu_gather_routes_to_plain_versions_without_launch():
    img, x, y, g = _inputs(SHAPES["ragged"], "spread")
    img_t, x_t, y_t = (torch.from_numpy(a).requires_grad_() for a in (img, x, y))
    before = (bilinear.bilinear_gather.launches, bilinear.bilinear_gather_backward.launches)
    out = bilinear.bilinear_gather(img_t, x_t, y_t, "zeros")
    out.backward(torch.from_numpy(g))
    assert (bilinear.bilinear_gather.launches,
            bilinear.bilinear_gather_backward.launches) == before
    want = _plain(img, x, y, g, "zeros")
    for got, w in zip((img_t.grad, x_t.grad, y_t.grad), want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert out.grad_fn is not None


@pytest.mark.parametrize("mode", MODES)
def test_gather_gradcheck_float64(mode):
    """Away from integer coordinates the gather is smooth in all inputs."""
    rng = np.random.default_rng(6)
    B, H, W, C = 1, 5, 6, 3
    img = torch.from_numpy(rng.normal(size=(B, H, W, C))).requires_grad_()
    base = rng.uniform(-1.5, 6.5, (2, B, 4, 3))
    frac = base - np.floor(base)
    base = np.where(np.abs(frac - 0.5) > 0.4, np.floor(base) + 0.5, base)  # off the integers
    x, y = (torch.from_numpy(a).requires_grad_() for a in base)
    assert torch.autograd.gradcheck(
        lambda i, a, b: bilinear.bilinear_gather(i, a, b, mode), (img, x, y), eps=1e-6,
        atol=1e-7, rtol=1e-5)


def test_backward_bad_padding_mode_raises():
    img, x, y, g = _inputs(SHAPES["ragged"], "spread")
    with pytest.raises(ValueError, match="padding_mode"):
        bilinear.bilinear_gather_backward(*(torch.from_numpy(a) for a in (img, x, y, g)),
                                          "reflect")
