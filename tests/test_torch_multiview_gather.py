"""K7, the multiview bilinear gather (one source sampled at G coordinate
sets, TrajGRU's warp), and K6's shared-source backward, in the port against
the JAX package.

The plain versions (what the port runs on a CPU tensor) are held to
``bilinear_gather_multiview_xla`` and its ``jax.vjp``, and to the Pallas
kernel ``gather_bilinear_multiview`` in interpret mode and its custom VJP
(``_backward_impl`` with ``shared=True``), fp32, zeros and border modes,
G in {1, 3, 13} and C in {3, 6, 16}, on the coordinate cases of
tests/torch_cases.py (integer coordinates, exact border edges, -1e6 and
dim+1e3), drawn anew for every view. The forward within 1e-5 abs; the
backward within 1e-4 abs, the bound of the JAX package's own test of this
VJP (tests/test_kernels.py, ``test_grads_match_xla``): d_img sums the views'
terms and d_x, d_y a view's channels in another order than JAX. View l must
land in channel block l. ``BilinearGatherMultiview`` on the CPU routes to
the plain versions with no kernel launch and passes
``torch.autograd.gradcheck`` in float64. The CUDA kernels are held to the
plain versions on the card in tests/test_torch_gpu.py. The JAX references
(the Pallas forward, the XLA reference and the VJP of each) are jitted once
per mode and reused across cases: unjitted, the interpreted Pallas kernel
runs op by op in every case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.kernels.bilinear_pallas import gather_bilinear_multiview
from kmunet_tpu.ops.sample import bilinear_gather_multiview_xla
from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.ops import sample
from tests.torch_cases import GATHER_CASES as CASES
from tests.torch_cases import MULTIVIEW_SHAPES as SHAPES
from tests.torch_cases import multiview_inputs, shifted_views
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = ("zeros", "border")
FWD_TOL = dict(rtol=0, atol=1e-5)
BWD_TOL = dict(rtol=0, atol=1e-4)


def _pallas_fn(mode):
    return lambda i, a, b: gather_bilinear_multiview(i, a, b, zeros=mode == "zeros",
                                                     interpret=True)


def _xla_fn(mode):
    return lambda i, a, b: bilinear_gather_multiview_xla(i, a, b, mode)


_FORWARDS = {"pallas": _pallas_fn, "xla": _xla_fn}


@functools.cache
def _forward(entry, mode):
    """The jitted JAX forward ``entry`` ("pallas" or "xla") in ``mode``."""
    return jax.jit(_FORWARDS[entry](mode))


@functools.cache
def _vjp(entry, mode):
    """The jitted cotangents (d_img, d_x, d_y) of ``entry`` in ``mode`` for
    an upstream gradient g."""
    fn = _FORWARDS[entry](mode)
    return jax.jit(lambda i, a, b, g: jax.vjp(fn, i, a, b)[1](g))


def _pallas(mode):
    return _forward("pallas", mode)


def _xla(mode):
    return _forward("xla", mode)


def _plain(img, x, y, mode):
    return bilinear.bilinear_gather_multiview_plain(
        *(torch.from_numpy(a) for a in (img, x, y)), mode).numpy()


def _plain_backward(img, x, y, g, mode):
    grads = bilinear.bilinear_gather_multiview_backward_plain(
        *(torch.from_numpy(a) for a in (img, x, y, g)), mode)
    return [t.numpy() for t in grads]


def _jax_vjp(entry, mode, img, x, y, g):
    return [np.asarray(a) for a in _vjp(entry, mode)(*(jnp.asarray(t) for t in (img, x, y, g)))]


def _assert_grads(got, want):
    for name, a, b in zip(("d_img", "d_x", "d_y"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", ["g1_c6", "g3_c3", "g3_c16", "g13_c6"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla(mode, shape, case):
    img, x, y, g = multiview_inputs(SHAPES[shape], case)
    want = np.asarray(_xla(mode)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    got = _plain(img, x, y, mode)
    assert got.shape == want.shape == (x.shape[0], *x.shape[2:], x.shape[1] * img.shape[-1])
    np.testing.assert_allclose(got, want, **FWD_TOL)
    _assert_grads(_plain_backward(img, x, y, g, mode), _jax_vjp("xla", mode, img, x, y, g))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", ["g1_c6", "g3_c3", "g3_c6", "g13_c16"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode, shape, case):
    img, x, y, g = multiview_inputs(SHAPES[shape], case, seed=1)
    want = np.asarray(_pallas(mode)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(_plain(img, x, y, mode), want, **FWD_TOL)
    _assert_grads(_plain_backward(img, x, y, g, mode), _jax_vjp("pallas", mode, img, x, y, g))


def test_view_l_lands_in_channel_block_l():
    """At integer coordinates x = j - dx_l, y = i - dy_l, view l is the
    source shifted by (dy_l, dx_l), zeros outside: the reference's (L, C)
    concat order, which TrajGRU's ``ret`` conv reads."""
    img = np.random.default_rng(3).normal(size=(2, 6, 7, 5)).astype(np.float32)
    shifts = [(0, 0), (1, 0), (0, -2), (-1, 3), (2, 2)]
    want, x, y = shifted_views(img, shifts)
    for mode in MODES:
        got = _plain(img, x, y, mode)
        if mode == "zeros":
            np.testing.assert_array_equal(got, want)
        else:  # border mode clamps instead: the inside agrees
            inside = np.zeros_like(want, dtype=bool)
            for v, (dy, dx) in enumerate(shifts):
                rows = slice(max(dy, 0), 6 + min(dy, 0))
                cols = slice(max(dx, 0), 7 + min(dx, 0))
                inside[:, rows, cols, v * 5:(v + 1) * 5] = True
            np.testing.assert_array_equal(got[inside], want[inside])
    np.testing.assert_allclose(want, np.asarray(_xla("zeros")(img, x, y)), rtol=0, atol=0)


def test_views_take_their_own_coordinates_and_share_d_img():
    """View g's channels equal the plain G=1 gather of the whole source at
    x[:, g], y[:, g]; d_x of view g sums over its C channels only, and d_img
    is the sum of the views' d_img."""
    img, x, y, g = multiview_inputs(SHAPES["g3_c16"], "spread", seed=2)
    out = _plain(img, x, y, "border")
    d_img, d_x, d_y = _plain_backward(img, x, y, g, "border")
    C = img.shape[-1]
    total = np.zeros_like(img)
    for k in range(x.shape[1]):
        cs = slice(C * k, C * k + C)
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (img, x[:, k], y[:, k], g[..., cs])]
        np.testing.assert_array_equal(out[..., cs], bilinear.bilinear_gather_plain(
            *args[:3], "border").numpy())
        one = bilinear.bilinear_gather_backward_plain(*args, "border")
        total += one[0].numpy()
        np.testing.assert_allclose(d_x[:, k], one[1].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d_y[:, k], one[2].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_img, total, rtol=0, atol=1e-5)


def test_cpu_multiview_gather_routes_to_plain_versions_without_launch():
    img, x, y, g = multiview_inputs(SHAPES["g3_c3"], "spread")
    img_t, x_t, y_t = (torch.from_numpy(a).requires_grad_() for a in (img, x, y))
    counters = (bilinear.bilinear_gather_multiview, bilinear.bilinear_gather_multiview_backward,
                bilinear.bilinear_gather_grouped, bilinear.bilinear_gather)
    before = [c.launches for c in counters]
    out = sample.bilinear_gather_multiview(img_t, x_t, y_t, "zeros")
    out.backward(torch.from_numpy(g))
    assert [c.launches for c in counters] == before
    np.testing.assert_array_equal(out.detach().numpy(), _plain(img, x, y, "zeros"))
    for got, w in zip((img_t.grad, x_t.grad, y_t.grad), _plain_backward(img, x, y, g, "zeros")):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("mode", MODES)
def test_multiview_gather_gradcheck_float64(mode):
    """Away from integer coordinates the multiview gather is smooth in all
    inputs; G=3 views of a 2-channel source."""
    rng = np.random.default_rng(6)
    B, H, W, C, G = 1, 5, 6, 2, 3
    img = torch.from_numpy(rng.normal(size=(B, H, W, C))).requires_grad_()
    base = rng.uniform(-1.5, 6.5, (2, B, G, 4, 3))
    frac = base - np.floor(base)
    base = np.where(np.abs(frac - 0.5) > 0.4, np.floor(base) + 0.5, base)  # off the integers
    x, y = (torch.from_numpy(a).requires_grad_() for a in base)
    assert torch.autograd.gradcheck(
        lambda i, a, b: bilinear.bilinear_gather_multiview(i, a, b, mode), (img, x, y),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_multiview_gather_rejects_what_it_does_not_take():
    img, x, y, g = multiview_inputs(SHAPES["g3_c3"], "spread")
    img_t, x_t, y_t, g_t = (torch.from_numpy(a) for a in (img, x, y, g))
    with pytest.raises(ValueError, match="B,G,Ho,Wo"):
        bilinear.bilinear_gather_multiview_plain(img_t, x_t[:, 0], y_t[:, 0])
    with pytest.raises(ValueError, match="B,G,Ho,Wo"):
        bilinear.bilinear_gather_multiview_plain(img_t[:1], x_t, y_t)
    with pytest.raises(ValueError, match="padding_mode"):
        bilinear.bilinear_gather_multiview_backward(img_t, x_t, y_t, g_t, "reflect")
