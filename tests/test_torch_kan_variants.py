"""The KAN variants against the JAX package, on the CPU.

Each of the eight trailing-axis layers (WavKAN in each of its five
wavelets) on (8, 12) inputs in [-1.5, 1.5] (past Chebyshev's clamp), with
converted, perturbed weights (tests/torch_parity.py): the output within
1e-5 abs, and the gradient of sum(out**2) with respect to the input and to
every parameter within 1e-4 of each one's largest |value| (Meyer's window
and Shannon's sinc lie 5e-5 and 2e-5 apart in fp32); past Chebyshev's
clamp JAX's input gradient is NaN and the port's 0. FasterKAN's gradient
is its hand-written one on both sides (the JAX layer's ``custom_vjp``, the
port's ``torch.autograd.Function``), which differs from the true
derivative. WavKAN in training (its BatchNorm on the batch's statistics,
the running ones after it). ``PatchKANConv2d`` around a Chebyshev and a
FastKAN layer, 3 x 3 patches with padding 1 and stride 1 and 2, on an
NCHW input against the JAX module's NHWC one, with the layer's gradients.
Each JAX function is jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.nn.kan_variants as kv_jax
from kmunet_tpu_torch import convert
from kmunet_tpu_torch.nn import kan_variants as kv
from tests.torch_parity import init_perturbed, nchw, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

IN, OUT = 12, 6
CASES = [("ChebyKANLayer", {"degree": 4}), ("FastKANLayer", {}), ("FasterKANLayer", {}),
         ("GRAMLayer", {}), ("JacobiKANLayer", {"degree": 4}), ("ReLUKANLayer", {}),
         ("RBFKANLayer", {})] + [("WavKANLayer", {"wavelet_type": w})
                                 for w in kv.WavKANLayer.WAVELETS]


def _x(seed=0, shape=(8, IN)):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, shape).astype(np.float32)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-12),
                               err_msg=name)


def _close_input_grad(got, want, x, clamped):
    """The input gradient; past Chebyshev's clamp (|x| >= 1) JAX's is NaN
    (0 times arccos's infinite slope at +-1 in its VJP), the port's 0, the
    clamped function's own."""
    want = np.asarray(want)
    if clamped:
        outside = np.abs(x) >= 1.0
        assert np.isnan(want[outside]).all() and (got[outside] == 0).all()
        got, want = np.where(outside, 0.0, got), np.where(outside, 0.0, want)
    _close(got, want, "x")


@pytest.mark.parametrize("name,kw", CASES, ids=lambda c: c if isinstance(c, str) else
                         "-".join(map(str, c.values())))
def test_variant_matches_jax(name, kw):
    jm = getattr(kv_jax, name)(features=OUT, **kw)
    x = _x(len(name))
    v = init_perturbed(jm, x, seed=len(name) + 1)
    tm = port(getattr(kv, name)(IN, OUT, **kw), v)
    want = jax.jit(jm.apply)(v, x)

    def loss(params, xx):
        return jnp.sum(jm.apply({**v, "params": params}, xx) ** 2)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], x)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    got.square().sum().backward()
    _close_input_grad(xt.grad.numpy(), g_x, x, name == "ChebyKANLayer")
    want_g = convert.to_state_dict(getattr(kv, name)(IN, OUT, **kw), g_params,
                                   v.get("batch_stats"))
    for key, p in tm.named_parameters():
        _close(p.grad.numpy(), want_g[key].numpy(), key)


def test_faster_kan_backward_is_the_reference_approximation():
    """The input gradient of the RSWAF basis is sum_g -2 tanh sech^2 g times
    inv_denominator (0.5), not the derivative of the forward: half of it."""
    x = torch.linspace(-1, 1, 7, dtype=torch.float64).requires_grad_()
    grid = torch.linspace(-1.2, 0.2, 8, dtype=torch.float64)
    kv._RSWAF.apply(x, grid, 0.5).sum().backward()
    t = torch.tanh(x.detach()[..., None] - grid)
    true_derivative = (-2 * t * (1 - t * t)).sum(-1)
    torch.testing.assert_close(x.grad, 0.5 * true_derivative)


@pytest.mark.parametrize("wavelet", ["mexican_hat", "meyer"])
def test_wavkan_train_mode_matches_jax(wavelet):
    jm = kv_jax.WavKANLayer(features=OUT, wavelet_type=wavelet)
    x = _x(9, (16, IN))
    v = init_perturbed(jm, x, seed=10)
    want, upd = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(v, x)
    tm = port(kv.WavKANLayer(IN, OUT, wavelet), v).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    stats = convert.to_state_dict(kv.WavKANLayer(IN, OUT, wavelet), v["params"],
                                  upd["batch_stats"])
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), stats[key].numpy(), rtol=0,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", ["ChebyKANLayer", "FastKANLayer"])
def test_patch_kan_conv_matches_jax(name, stride):
    """The output and the layer's parameter gradients; the input gradient
    with FastKAN (with Chebyshev JAX's NaNs past the clamp reach every
    pixel through the patches' transpose, 0 x NaN; the port's is finite)."""
    Cin = 3
    x = _x(11, (2, 7, 9, Cin))
    jm = kv_jax.PatchKANConv2d(layer=getattr(kv_jax, name)(features=4), kernel_size=3,
                               stride=stride, padding=1)
    v = init_perturbed(jm, x, seed=12)
    tm = port(kv.PatchKANConv2d(getattr(kv, name)(Cin * 9, 4), kernel_size=3, stride=stride,
                                padding=1), v)
    want = np.asarray(jax.jit(jm.apply)(v, x))

    def loss(params, xx):
        return jnp.sum(jm.apply({"params": params}, xx) ** 2)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], x)
    xt = nchw(x).requires_grad_()
    got = tm(xt)
    assert got.shape == (2, 4) + want.shape[1:3]
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-5)
    got.square().sum().backward()
    g = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(g).all()
    if name != "ChebyKANLayer":
        _close(g, g_x, "x")
    want_g = convert.to_state_dict(tm, g_params)
    for key, p in tm.named_parameters():
        _close(p.grad.numpy(), want_g[key].numpy(), key)
