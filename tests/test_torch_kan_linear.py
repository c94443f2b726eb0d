"""The rest of KAN and of the losses against the JAX package, on the CPU:
``KANLinear`` (forward, input and parameter gradients with converted,
perturbed weights, within 1e-5 abs), ``kan_regularization_loss`` on
converted KM_UNetV3-SH and KANLinear parameters (within 1e-5 relative),
``update_grid`` (the refit grid and weights, a rank-deficient fit among
them) with JAX's pinv cutoff, ``en_rainfall_loss`` and
``ssim_torchmetrics`` (value and gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.losses.losses import en_rainfall_loss as en_rainfall_loss_jax
from kmunet_tpu.models.km_unet import KM_UNetV3_SH as KM_UNetV3_SH_jax
from kmunet_tpu.nn import kan as kan_jax
from kmunet_tpu.ops import spline as spline_jax
from kmunet_tpu.ops.ssim import ssim_torchmetrics as ssim_torchmetrics_jax
from kmunet_tpu_torch import convert
from kmunet_tpu_torch.losses import en_rainfall_loss
from kmunet_tpu_torch.models.km_unet import KM_UNetV3_SH
from kmunet_tpu_torch.nn.kan import KANConv2d, KANLinear, kan_regularization_loss
from kmunet_tpu_torch.ops import spline
from kmunet_tpu_torch.ops.ssim import ssim_torchmetrics
from tests.torch_parity import init_perturbed

ATOL = 1e-5
REG_RTOL = 1e-5


def _uniform(shape, seed, lo=-1.2, hi=1.2):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


@pytest.mark.parametrize("in_features,features,grid_size", [(5, 7, 5), (3, 4, 8)])
def test_kan_linear_matches_jax(in_features, features, grid_size):
    """x in [-1.2, 1.2], past the grid on both sides: the output, the input
    gradient and the three parameter gradients."""
    x = _uniform((4, 6, in_features), 0)
    g = np.random.default_rng(1).normal(size=(4, 6, features)).astype(np.float32)
    jm = kan_jax.KANLinear(features=features, grid_size=grid_size)
    variables = init_perturbed(jm, jnp.asarray(x), seed=2)
    out, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), variables["params"],
                       jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(g))
    tm = convert.load_flax(KANLinear(in_features, features, grid_size=grid_size),
                           variables["params"])
    x_t = torch.from_numpy(x).requires_grad_()
    got = tm(x_t)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(d_x), rtol=0, atol=ATOL)
    want = convert.to_state_dict(tm, d_params)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0, atol=ATOL, err_msg=k)


def test_kan_linear_converter_is_strict_and_init_is_seeded():
    jm = kan_jax.KANLinear(features=4)
    params = init_perturbed(jm, jnp.zeros((2, 3)), seed=0)["params"]
    tm = KANLinear(3, 4)
    sd = convert.to_state_dict(tm, params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "base_weight": (4, 3), "spline_weight": (4, 3, 8), "spline_scaler": (4, 3)}
    with pytest.raises(KeyError, match="unused flax leaves"):
        convert.to_state_dict(tm, {**params, "bias": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="unfilled torch keys"):
        convert.to_state_dict(tm, {k: v for k, v in params.items() if k != "spline_scaler"})
    a, b = KANLinear(3, 4), KANLinear(3, 4)
    a.init_weights_(torch.Generator().manual_seed(0))
    b.init_weights_(torch.Generator().manual_seed(0))
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    # The spline fits noise of scale 0.1 / grid_size at the interior knots.
    assert 0 < float(a.spline_weight.abs().max()) < 0.1


def test_spline_noise_init_fits_the_noise_in_both_layers():
    """The shared curve2coeff init (``spline_noise_coeff``): each spline of
    KANConv2d and KANLinear, evaluated at the interior knots, is the
    uniform noise it was fit to, within +-scale_noise / grid_size / 2, and
    not flat."""
    conv, lin = KANConv2d(2, 3, kernel_size=3), KANLinear(18, 3)
    conv.init_weights_(torch.Generator().manual_seed(4))
    lin.init_weights_(torch.Generator().manual_seed(4))
    kn = spline.knots(5, 3)
    basis = spline.bspline_basis(kn[3:-3][:, None], kn[None, :], 3)[:, 0, :]  # (6, 8)
    with torch.no_grad():
        for w in (conv.spline_weight.permute(0, 1, 3, 4, 2).reshape(3, 18, 8),
                  lin.spline_weight):
            values = torch.einsum("gb,fib->gfi", basis, w)
            assert float(values.abs().max()) <= 0.1 / 5 / 2 * (1 + 1e-5)
            assert float(values.std()) > 0.1 / 5 / 8


def test_kan_regularization_loss_matches_jax():
    """On KM_UNetV3-SH's four KANConv2d layers (spline_kernel (k, k, C, 8,
    F) in JAX, spline_weight (F, C, 8, k, k) in the port) and on a
    KANLinear's, separately and together; 0 without KAN layers."""
    model_jax = KM_UNetV3_SH_jax(num_classes=4, embed_dims=(16, 32, 64))
    sh = init_perturbed(model_jax, jnp.zeros((1, 32, 32, 5)), seed=5)
    lin = init_perturbed(kan_jax.KANLinear(features=6), jnp.zeros((2, 5)), seed=6)
    model = convert.load_flax(KM_UNetV3_SH(num_classes=4, embed_dims=(16, 32, 64)),
                              sh["params"], sh["batch_stats"])
    lin_t = convert.load_flax(KANLinear(5, 6), lin["params"])
    named_sh = dict(model.named_parameters())
    assert sum(k.endswith(".spline_weight") for k in named_sh) == 4
    named_lin = {f"head.{k}": p for k, p in lin_t.named_parameters()}
    for port_params, jax_params in [(named_sh, sh["params"]), (named_lin, lin["params"]),
                                    ({**named_sh, **named_lin},
                                     {"sh": sh["params"], "head": lin["params"]})]:
        want = float(jax.jit(kan_jax.kan_regularization_loss)(jax_params))
        got = float(kan_regularization_loss(port_params).detach())
        np.testing.assert_allclose(got, want, rtol=REG_RTOL)
    assert float(kan_regularization_loss({"conv.weight": torch.ones(3, 3)})) == 0.0
    assert float(kan_jax.kan_regularization_loss({"conv": {"kernel": jnp.ones((3, 3))}})) == 0.0


def _update_grid_case(seed, rank_deficient):
    """x (64, 3), the uniform grid and a scaled spline weight (3, 8, 4) in
    JAX's layout. Rank-deficient: feature 0 constant (its new grid spans
    2 margins and the samples meet 4 of the 8 bases in one point: rank
    1), feature 1 on two values (rank 2)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)
    if rank_deficient:
        x[:, 0] = 0.3
        x[:, 1] = np.where(rng.uniform(size=64) < 0.5, -0.4, 0.5)
    grid = np.asarray(spline_jax.make_uniform_grid(3))
    w = rng.normal(size=(3, 8, 4)).astype(np.float32)
    return x, grid, w


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_update_grid_matches_jax(rank_deficient):
    """The new grid within 1e-6 abs, the refit weights within 1e-4 of their
    largest |value|, and on the samples the refit spline's outputs within
    1e-4 of JAX's (the min-norm fit with JAX's cutoff)."""
    x, grid, w = _update_grid_case(7, rank_deficient)
    want_grid, want_w = jax.jit(spline_jax.update_grid)(jnp.asarray(x), jnp.asarray(grid),
                                                        jnp.asarray(w))
    got_grid, got_w = spline.update_grid(torch.from_numpy(x), torch.tensor(grid),
                                         torch.from_numpy(w).permute(2, 0, 1))
    np.testing.assert_allclose(got_grid.numpy(), np.asarray(want_grid), rtol=0, atol=1e-6)
    want_w = np.array(want_w).transpose(2, 0, 1)  # (out, in, n), KANLinear's layout
    scale = np.abs(want_w).max()
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-4 * scale)
    basis = spline.bspline_basis(torch.from_numpy(x), got_grid, 3)
    got_out = torch.einsum("bif,oif->bio", basis, got_w)
    want_out = torch.einsum("bif,oif->bio", basis, torch.from_numpy(want_w))
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=1e-4 * float(want_out.abs().max()))
    if rank_deficient:  # feature 0's fit keeps only the one direction its samples see
        ranks = torch.linalg.matrix_rank(basis.transpose(0, 1), rtol=1e-4)
        assert ranks.tolist()[:2] == [1, 2]


def test_pinv_cuts_as_jax():
    """A (64, 8) matrix with singular values 1, 0.5 and 3e-5 (the rest 0):
    JAX's cutoff (10 * 64 * eps = 7.6e-5 relative) drops 3e-5,
    ``torch.linalg.pinv``'s default (7.6e-6) keeps it (and its inverse,
    3.3e4)."""
    rng = np.random.default_rng(8)
    u, _ = np.linalg.qr(rng.normal(size=(64, 3)))
    v, _ = np.linalg.qr(rng.normal(size=(8, 3)))
    a = (u * np.array([1.0, 0.5, 3e-5])) @ v.T
    a = a.astype(np.float32)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(a)))
    got = spline.pinv(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(torch.linalg.pinv(torch.from_numpy(a)).numpy()).max() > 1e3


def test_en_rainfall_loss_value_and_gradient_match_jax():
    p = np.random.default_rng(9).uniform(size=(2, 4, 16, 16)).astype(np.float32)
    t = np.random.default_rng(10).uniform(size=(2, 4, 16, 16)).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda a: en_rainfall_loss_jax(a, jnp.asarray(t)))(jnp.asarray(p))
    assert float(jnp.mean(jnp.asarray(t) >= 0.7)) > 0.2  # the heavy-rain terms are on
    p_t = torch.from_numpy(p).requires_grad_()
    got = en_rainfall_loss(p_t, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("shape", [(2, 3, 20, 17), (3, 24, 24)])
def test_ssim_torchmetrics_value_and_gradient_match_jax(shape):
    p = np.random.default_rng(11).uniform(size=shape).astype(np.float32)
    t = np.random.default_rng(12).uniform(size=shape).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda a: ssim_torchmetrics_jax(a, jnp.asarray(t)))(jnp.asarray(p))
    p_t = torch.from_numpy(p).requires_grad_()
    got = ssim_torchmetrics(p_t, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=1e-6)
    # The mean over every image scales each gradient down: its elements
    # that cancel lie 1.7e-6 of the largest apart.
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(p_t.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-5 * np.abs(want_grad).max())
