"""K4, the grouped bilinear gather, and K6's grouped backward, in the port
against the JAX package, and ``grid_sample_bilinear``.

The plain versions (what the port runs on a CPU tensor) are held to
``bilinear_gather_grouped_xla`` and its ``jax.vjp``, and to the Pallas
kernel ``gather_bilinear_grouped`` in interpret mode and its custom VJP
(``_backward_impl`` with ``shared=False``), fp32, zeros and border modes,
G in {1, 2, 4} with Cg in {3, 6, 16}, on the coordinate cases of
tests/torch_cases.py (integer coordinates, exact border edges, -1e6 and
dim+1e3), drawn anew for every group. The forward within 1e-6 abs (the same
4-tap blend, a few roundings in another order); the backward within 1e-5
abs plus 1e-5 relative (d_x and d_y sum over a group's channels in another
order than JAX). ``BilinearGatherGrouped`` on the CPU routes to the plain
versions with no kernel launch and passes ``torch.autograd.gradcheck`` in
float64. The CUDA kernels are held to the plain versions on the card in
tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kmunet_tpu.kernels.bilinear_pallas import gather_bilinear_grouped
from kmunet_tpu.ops.sample import bilinear_gather_grouped_xla
from kmunet_tpu.ops.sample import grid_sample_bilinear as grid_sample_jax
from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.ops import sample
from tests.torch_cases import GATHER_CASES as CASES
from tests.torch_cases import GROUPED_SHAPES as SHAPES
from tests.torch_cases import grouped_inputs

MODES = ("zeros", "border")
FWD_TOL = dict(rtol=0, atol=1e-6)
BWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _pallas(mode):
    return lambda i, a, b: gather_bilinear_grouped(i, a, b, zeros=mode == "zeros", interpret=True)


def _xla(mode):
    return lambda i, a, b: bilinear_gather_grouped_xla(i, a, b, mode)


def _plain(img, x, y, mode):
    return bilinear.bilinear_gather_grouped_plain(
        *(torch.from_numpy(a) for a in (img, x, y)), mode).numpy()


def _plain_backward(img, x, y, g, mode):
    grads = bilinear.bilinear_gather_grouped_backward_plain(
        *(torch.from_numpy(a) for a in (img, x, y, g)), mode)
    return [t.numpy() for t in grads]


def _jax_vjp(fn, img, x, y, g):
    _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _assert_grads(got, want):
    for name, a, b in zip(("d_img", "d_x", "d_y"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla(mode, shape, case):
    img, x, y, g = grouped_inputs(SHAPES[shape], case)
    want = np.asarray(_xla(mode)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    got = _plain(img, x, y, mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FWD_TOL)
    _assert_grads(_plain_backward(img, x, y, g, mode), _jax_vjp(_xla(mode), img, x, y, g))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", ["g2_cg3", "g4_cg6"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode, shape, case):
    img, x, y, g = grouped_inputs(SHAPES[shape], case, seed=1)
    want = np.asarray(_pallas(mode)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(_plain(img, x, y, mode), want, **FWD_TOL)
    _assert_grads(_plain_backward(img, x, y, g, mode), _jax_vjp(_pallas(mode), img, x, y, g))


def test_groups_take_their_own_coordinates():
    """Group g's channels equal the plain G=1 gather of those channels at
    x[:, g], y[:, g], and d_x of group g sums over group g's channels only."""
    img, x, y, g = grouped_inputs(SHAPES["g4_cg6"], "spread", seed=2)
    out = _plain(img, x, y, "border")
    d_img, d_x, d_y = _plain_backward(img, x, y, g, "border")
    for k in range(4):
        cs = slice(6 * k, 6 * k + 6)
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (img[..., cs], x[:, k], y[:, k], g[..., cs])]
        np.testing.assert_array_equal(out[..., cs], bilinear.bilinear_gather_plain(
            *args[:3], "border").numpy())
        one = bilinear.bilinear_gather_backward_plain(*args, "border")
        np.testing.assert_allclose(d_img[..., cs], one[0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d_x[:, k], one[1].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d_y[:, k], one[2].numpy(), rtol=0, atol=1e-6)


def test_cpu_grouped_gather_routes_to_plain_versions_without_launch():
    img, x, y, g = grouped_inputs(SHAPES["g4_cg6"], "spread")
    img_t, x_t, y_t = (torch.from_numpy(a).requires_grad_() for a in (img, x, y))
    counters = (bilinear.bilinear_gather_grouped, bilinear.bilinear_gather_grouped_backward,
                bilinear.bilinear_gather, bilinear.bilinear_gather_backward)
    before = [c.launches for c in counters]
    out = bilinear.bilinear_gather_grouped(img_t, x_t, y_t, "zeros")
    out.backward(torch.from_numpy(g))
    assert [c.launches for c in counters] == before
    np.testing.assert_array_equal(out.detach().numpy(), _plain(img, x, y, "zeros"))
    for got, w in zip((img_t.grad, x_t.grad, y_t.grad), _plain_backward(img, x, y, g, "zeros")):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("mode", MODES)
def test_grouped_gather_gradcheck_float64(mode):
    """Away from integer coordinates the grouped gather is smooth in all
    inputs; G=3 groups of 2 channels."""
    rng = np.random.default_rng(6)
    B, H, W, C, G = 1, 5, 6, 6, 3
    img = torch.from_numpy(rng.normal(size=(B, H, W, C))).requires_grad_()
    base = rng.uniform(-1.5, 6.5, (2, B, G, 4, 3))
    frac = base - np.floor(base)
    base = np.where(np.abs(frac - 0.5) > 0.4, np.floor(base) + 0.5, base)  # off the integers
    x, y = (torch.from_numpy(a).requires_grad_() for a in base)
    assert torch.autograd.gradcheck(
        lambda i, a, b: bilinear.bilinear_gather_grouped(i, a, b, mode), (img, x, y), eps=1e-6,
        atol=1e-7, rtol=1e-5)


def test_grouped_gather_rejects_what_it_does_not_take():
    img, x, y, g = grouped_inputs(SHAPES["g4_cg6"], "spread")
    img_t, x_t, y_t, g_t = (torch.from_numpy(a) for a in (img, x, y, g))
    with pytest.raises(ValueError, match="multiple of G"):
        bilinear.bilinear_gather_grouped_plain(img_t[..., :22], x_t, y_t)
    with pytest.raises(ValueError, match="B,G,Ho,Wo"):
        bilinear.bilinear_gather_grouped_plain(img_t, x_t[:, 0], y_t[:, 0])
    with pytest.raises(ValueError, match="padding_mode"):
        bilinear.bilinear_gather_grouped_backward(img_t, x_t, y_t, g_t, "reflect")


GRID_CASES = [(ac, mode) for ac in (False, True) for mode in MODES]


@pytest.mark.parametrize("align_corners,mode", GRID_CASES)
def test_grid_sample_bilinear_matches_jax_and_torch(align_corners, mode):
    """Forward against the JAX package's ``grid_sample_bilinear`` and
    ``F.grid_sample`` (NCHW) within 1e-5; the gradients to the image and the
    grid against JAX's within 1e-5 abs + 1e-5 relative. The grid reaches
    past [-1, 1]."""
    rng = np.random.default_rng(8)
    img = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 9, 4, 2)).astype(np.float32)
    g = rng.normal(size=(2, 9, 4, 5)).astype(np.float32)

    def fn(i, gr):
        return grid_sample_jax(i, gr, align_corners=align_corners, padding_mode=mode)

    want, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(grid))
    want_grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    img_t, grid_t = (torch.from_numpy(a).requires_grad_() for a in (img, grid))
    got = sample.grid_sample_bilinear(img_t, grid_t, align_corners=align_corners,
                                      padding_mode=mode)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    lib = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
                        mode="bilinear", padding_mode=mode, align_corners=align_corners)
    np.testing.assert_allclose(got.detach().numpy(), lib.permute(0, 2, 3, 1).numpy(), rtol=0,
                               atol=1e-5)
    for a, b in zip((img_t.grad, grid_t.grad), want_grads):
        np.testing.assert_allclose(a.numpy(), b, **BWD_TOL)
