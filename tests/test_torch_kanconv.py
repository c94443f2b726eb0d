"""K1, the fused KAN conv: the port's plain version, ``FusedKANConv``'s
backward and ``KANConv2d(fused=True)`` against the JAX package, on the CPU.

The plain version against ``fused_kanconv`` (the Pallas kernel, which runs
interpreted off the TPU) and ``kanconv_reference`` at the four KAN shapes of
KM_UNetV3-SH scaled to B=2, 16^2, and a ragged C=3, F=5, 7x9, with x drawn
from [-1.2, 1.2], from [-3, 3] (past the outer knots, where fewer than 4
bases are nonzero) and exactly at the knots: fp32 within 1e-4 abs (the
per-layer bound of BASELINE.json). ``FusedKANConv``'s gradients (its backward
is the plain version's autograd; its forward, K1, runs on the card only, so
the plain version stands in for it here) against ``jax.vjp(fused_kanconv)``
within 1e-4 of each leaf's largest |gradient|. ``KANConv2d(fused=True)``
with converted, perturbed params against the JAX module, forward and all
gradients. The dispatch: on the CPU no counter moves, and the launcher
refuses a CPU tensor, an unsupported dtype and bad shapes. Each JAX function
is jitted, so that it compiles once per shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.kernels.kanconv_pallas import fused_kanconv as fused_kanconv_jax
from kmunet_tpu.kernels.kanconv_pallas import kanconv_reference
from kmunet_tpu.nn import kan as kan_jax
from kmunet_tpu_torch import convert
from kmunet_tpu_torch.kernels import kanconv
from kmunet_tpu_torch.nn import kan
from tests.torch_parity import init_perturbed, nchw, nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4
# (B, H, W, C, F): enc1 16->16, enc2 16->32, enc3 32->64, dec1 64->32 at 16^2, B=2; ragged.
SHAPES = {
    "enc1": (2, 16, 16, 16, 16),
    "enc2": (2, 16, 16, 16, 32),
    "enc3": (2, 16, 16, 32, 64),
    "dec1": (2, 16, 16, 64, 32),
    "ragged": (2, 7, 9, 3, 5),
}
# The extended grid's knots, -2.2 .. 2.2 in steps of 0.4, as fp32 values.
KNOTS = (-1.0 + 0.4 * np.arange(-3, 9)).astype(np.float32)
X_CASES = ("unit", "wide", "knots")


def _inputs(shape, case, seed):
    """xp (B, H+2, W+2, C) NHWC, base_k (3, 3, C, F), sk_flat (3, 3, 8C, F),
    numpy fp32, in the JAX package's layout."""
    B, H, W, C, F = shape
    rng = np.random.default_rng(seed)
    size = (B, H + 2, W + 2, C)
    if case == "unit":
        xp = rng.uniform(-1.2, 1.2, size)
    elif case == "wide":
        xp = rng.uniform(-3.0, 3.0, size)
    else:
        xp = rng.choice(KNOTS, size)
    bk = 0.3 * rng.normal(size=(3, 3, C, F))
    sk = 0.3 * rng.normal(size=(3, 3, 8 * C, F))
    return [a.astype(np.float32) for a in (xp, bk, sk)]


def _port_layout(xp, bk, sk):
    """NCHW xp and OIHW weights (the c-major flat spline kernel keeps its
    channel order)."""
    return (nchw(xp), torch.from_numpy(np.ascontiguousarray(bk.transpose(3, 2, 0, 1))),
            torch.from_numpy(np.ascontiguousarray(sk.transpose(3, 2, 0, 1))))


_jax_kernel = jax.jit(fused_kanconv_jax)
_jax_reference = jax.jit(kanconv_reference)


@pytest.mark.parametrize("case", X_CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_jax_kernel_and_reference(shape, case):
    xp, bk, sk = _inputs(SHAPES[shape], case, seed=sum(SHAPES[shape]) + X_CASES.index(case))
    got = nhwc(kanconv.kanconv_plain(*_port_layout(xp, bk, sk)))
    want_ref = np.asarray(_jax_reference(xp, bk, sk))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    if case != "knots" or shape == "ragged":  # the kernel once per shape, and at the knots
        want = np.asarray(_jax_kernel(xp, bk, sk))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["wide", "knots"])
@pytest.mark.parametrize("shape", ["enc2", "ragged"])
def test_fused_kanconv_backward_matches_jax_vjp(shape, case, monkeypatch):
    """``FusedKANConv.apply`` with the plain version in place of K1's launcher:
    its backward (the plain version's autograd, as on the card) against
    ``jax.vjp`` of the Pallas kernel, for xp, base and spline."""
    xp, bk, sk = _inputs(SHAPES[shape], case, seed=7)
    g = np.random.default_rng(8).normal(size=SHAPES[shape][:3] + SHAPES[shape][4:])
    g = g.astype(np.float32)
    out, vjp = jax.vjp(fused_kanconv_jax, xp, bk, sk)
    want = jax.jit(vjp)(jnp.asarray(g))
    monkeypatch.setattr(kanconv, "kanconv_forward", kanconv.kanconv_plain)
    leaves = [t.requires_grad_() for t in _port_layout(xp, bk, sk)]
    got = kanconv.FusedKANConv.apply(*leaves)
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    got.backward(nchw(g))
    for name, t, w, perm in (("xp", leaves[0], want[0], (0, 2, 3, 1)),
                             ("base", leaves[1], want[1], (2, 3, 1, 0)),
                             ("spline", leaves[2], want[2], (2, 3, 1, 0))):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy().transpose(perm), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (2, 7, 9, 3, 5)])
def test_kanconv2d_fused_matches_jax_module(shape):
    """Converted, perturbed params (spline scalers in [-1, 1]); the input
    drawn from [-3, 3] so that the zero padding and the outer knots are
    both crossed; forward and the gradients of x and every parameter."""
    B, H, W, C, F = shape
    rng = np.random.default_rng(3)
    x = rng.uniform(-3.0, 3.0, (B, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, H, W, F)).astype(np.float32)
    jm = kan_jax.KANConv2d(features=F, kernel_size=3, padding=1)
    variables = init_perturbed(jm, jnp.asarray(x), seed=4)
    out, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), variables["params"],
                       jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(g))
    tm = kan.KANConv2d(C, F, kernel_size=3, padding=1, fused=True)
    convert.load_flax(tm, variables["params"])
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    want = convert.to_state_dict(tm, d_params)
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-4 * float(want[key].abs().max()), err_msg=key)


def test_kanconv2d_fused_takes_only_k1s_configuration():
    with pytest.raises(ValueError, match="kernel_size 3"):
        kan.KANConv2d(4, 4, kernel_size=5, fused=True)
    with pytest.raises(ValueError, match="grid_size 5"):
        kan.KANConv2d(4, 4, grid_size=6, fused=True)


def test_cpu_dispatch_takes_the_plain_version_and_counts_nothing():
    xp, bk, sk = _port_layout(*_inputs(SHAPES["ragged"], "wide", seed=5))
    before = kanconv.fused_kanconv.launches
    leaves = [t.clone().requires_grad_() for t in (xp, bk, sk)]
    out = kanconv.fused_kanconv(*leaves)
    out.sum().backward()
    assert kanconv.fused_kanconv.launches == before
    assert torch.equal(out.detach(), kanconv.kanconv_plain(xp, bk, sk))
    assert all(t.grad is not None for t in leaves)


def test_launcher_refuses_what_k1_does_not_take():
    xp, bk, sk = _port_layout(*_inputs(SHAPES["ragged"], "unit", seed=6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kanconv.kanconv_forward(xp, bk, sk)
    with pytest.raises(TypeError, match="dtype"):
        kanconv.kanconv_forward(xp.double(), bk, sk)
    with pytest.raises(ValueError, match="3x3"):
        kanconv.kanconv_forward(xp, bk[..., :2, :2], sk)
    with pytest.raises(ValueError, match="spline_flat"):
        kanconv.kanconv_forward(xp, bk, sk[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        kanconv.kanconv_forward(xp.transpose(2, 3), bk, sk)
