"""DySample's exact path (``window=False``, the K4 grouped gather) in the port
against the JAX package, on the CPU.

``DySample`` in every style ('lp', 'pl') x dyscope x window combination,
forward and gradients (input and parameters), with converted, perturbed
weights (tests/torch_parity.py), fp32, within 1e-4 abs (the per-layer bound
of BASELINE.json); the strict converter on the 'pl' offset and the scope
conv; ``pixel_shuffle`` / ``pixel_unshuffle``; the bf16 exact
path's sampling coordinates bit for bit against JAX's; the whole
``KM_UNetV3_SH(dysample_window=False)`` at 32^2 against the JAX model with
``DYSAMPLE_WINDOW=False`` within 1e-4; and one SH train step on the exact
path against ``kmunet_tpu.train.engine``, held as
tests/test_torch_train.py holds the window path's (its constants and
checks, imported). JAX's gather takes its XLA path on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.models.km_unet import KM_UNetV3_SH as KM_UNetV3_SH_jax
from kmunet_tpu_torch import configs, convert, serve
from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.models.km_unet import KM_UNetV3_SH
from kmunet_tpu_torch.nn import resample
from kmunet_tpu_torch.train import engine
from tests.test_torch_train import _assert_step_matches, _recording, _small_config
from tests.torch_parity import init_perturbed, nchw, nhwc, port

ATOL = 1e-4
COMBOS = [(style, dyscope, window) for style in ("lp", "pl") for dyscope in (False, True)
          for window in (False, True)]


@pytest.fixture
def jax_xla_gather():
    """The JAX package's gather on its XLA path (its default on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        yield


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("style,dyscope,window", COMBOS)
def test_dysample_matches_jax(jax_xla_gather, style, dyscope, window):
    """Output, input gradient and every parameter gradient within 1e-4;
    the perturbed offset convs move the samples by tenths of a pixel."""
    x = _normal((2, 5, 6, 8), 0)
    g = _normal((2, 10, 12, 8), 1)
    jm = resample_jax.DySample(scale=2, style=style, groups=4, dyscope=dyscope, window=window)
    variables = init_perturbed(jm, jnp.asarray(x), seed=2)
    out, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), variables["params"],
                       jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(g))
    tm = port(resample.DySample(8, scale=2, style=style, groups=4, dyscope=dyscope,
                                window=window), variables)
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    want = convert.to_state_dict(tm, d_params)
    assert set(want) == {k for k, _ in tm.named_parameters()}
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), rtol=0, atol=ATOL,
                                   err_msg=key)


def test_converter_carries_scope_and_pl_offset():
    """The strict converter maps the 'pl' offset conv (2g outputs over C/4
    inputs) and the bias-free dyscope ``scope`` conv, and refuses a missing
    or a stray scope."""
    x = _normal((1, 4, 4, 8), 5)
    jm = resample_jax.DySample(scale=2, style="pl", groups=4, dyscope=True)
    params = init_perturbed(jm, jnp.asarray(x), seed=6)["params"]
    sd = convert.to_state_dict(resample.DySample(8, style="pl", dyscope=True), params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "offset.weight": (8, 2, 1, 1), "offset.bias": (8,), "scope.weight": (8, 2, 1, 1)}
    with pytest.raises(KeyError, match="scope"):
        convert.to_state_dict(resample.DySample(8, style="pl", dyscope=True),
                              {"offset": params["offset"]})
    with pytest.raises(KeyError, match="scope"):
        convert.to_state_dict(resample.DySample(8, style="pl"), params)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax(r):
    x = _normal((2, 3, 4, 2 * r * r), 3)
    want = np.asarray(resample_jax.pixel_shuffle(jnp.asarray(x), r))
    got = resample.pixel_shuffle(nchw(x), r)
    np.testing.assert_array_equal(nhwc(got), want)
    back = np.asarray(resample_jax.pixel_unshuffle(jnp.asarray(want), r))
    np.testing.assert_array_equal(nhwc(resample.pixel_unshuffle(got, r)), back)
    np.testing.assert_array_equal(back, x)


def _record(mp, module):
    """Replace ``module.bilinear_gather_grouped`` by a wrapper that keeps its
    coordinates (as fp32 numpy)."""
    seen = []
    inner = module.bilinear_gather_grouped

    def gather(img, x, y, padding_mode="border"):
        seen.append((np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy(),
                     np.asarray(y, np.float32) if not torch.is_tensor(y) else y.float().numpy()))
        return inner(img, x, y, padding_mode=padding_mode)

    mp.setattr(module, "bilinear_gather_grouped", gather)
    return seen


def test_exact_path_bf16_coordinates_match_jax(jax_xla_gather):
    """bf16 at 64x64: the offset conv's inputs and weights are chosen so
    that both frameworks' bf16 convs are exact (integers times multiples of
    1/64), so both sides hold the same offsets; the sampling coordinates
    handed to the gather must then be equal bit for bit. They are built in
    bf16 in the JAX order (j + 0.5 + init + offset, then - 0.5): built in
    fp32 they land elsewhere (bf16 spacing is 0.25 px at 32-64), which the
    test checks too. The outputs agree within 2 bf16 ulps of their scale."""
    rng = np.random.default_rng(4)
    B, H, W, C, G = 1, 64, 64, 8, 4
    x = rng.integers(-2, 3, (B, H, W, C)).astype(np.float32)
    params = {"offset": {"kernel": (rng.integers(-4, 5, (1, 1, C, 2 * G * 4)) / 64.0),
                         "bias": rng.integers(-8, 9, (2 * G * 4,)) / 64.0}}
    jm = resample_jax.DySample(scale=2, style="lp", groups=G, window=False)
    tm = convert.load_flax(resample.DySample(C, window=False), params).to(torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        seen_jax = _record(mp, resample_jax)
        seen_port = _record(mp, resample)
        pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
        want = np.asarray(jm.apply({"params": pb}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        with torch.no_grad():
            got = tm(nchw(x).bfloat16()).float()
    (jx, jy), (px, py) = seen_jax[0], seen_port[0]
    assert jx.shape == px.shape == (B, G, 2 * H, 2 * W)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    with torch.no_grad():  # the same coordinates built in fp32 differ
        off = tm.offset(nchw(x).bfloat16()).float() * 0.25
    jj = torch.arange(W, dtype=torch.float32)
    x32 = (jj + 0.5 + 0.25 + off.reshape(B, G, 2, 2, 2, H, W)[:, :, 1, 1, 0] - 0.5)
    assert not np.array_equal(x32.numpy(), px[:, :, 1::2, 1::2])
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=2 * ulp)


def test_full_model_exact_path_matches_jax():
    """The whole SH model at 32^2, B2, 5 -> 20, embed_dims (16, 32, 64), fp32,
    perturbed weights, ``DYSAMPLE_WINDOW=False`` on the JAX side and
    ``dysample_window=False`` in the port: within 1e-4 abs, the three
    DySamples through the grouped gather (plain on the CPU, no launch)."""
    x = np.random.default_rng(0).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", False)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        jm = KM_UNetV3_SH_jax(num_classes=20, embed_dims=(16, 32, 64))
        variables = init_perturbed(jm, jnp.asarray(x), seed=3)
        want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
        calls = []
        inner = resample.bilinear_gather_grouped
        mp.setattr(resample, "bilinear_gather_grouped",
                   lambda *a, **k: calls.append(a[1].shape) or inner(*a, **k))
        model = port(KM_UNetV3_SH(dysample_window=False), variables)
        before = bilinear.bilinear_gather_grouped.launches
        got = serve.predict(model, x).numpy()
    assert calls == [(2, 4, 8, 8), (2, 4, 16, 16), (2, 4, 32, 32)]
    assert bilinear.bilinear_gather_grouped.launches == before
    assert got.shape == (2, 32, 32, 20) and np.isfinite(got).all() and want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def jax_exact_step():
    """One SH train step of the JAX engine on the exact path, at the small
    config of tests/test_torch_train.py, compiled once at XLA's default
    optimisation level (3): the initial variables, and the step's metrics,
    gradients and variables after it."""
    cfg = _small_config(configs_jax.shanghai_km_unet())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", False)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        model = engine_jax.build_model(cfg)
        tx = _recording(engine_jax.build_optimizer(cfg, steps_per_epoch=10))
        state = engine_jax.init_state(cfg, model, tx, jax.random.PRNGKey(0))
        initial = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                       compiler_options={"xla_backend_optimization_level": 3})
        batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
        state, m = step(state, jnp.asarray(batch), jax.random.PRNGKey(3))
        want = jax.device_get({
            "metrics": (float(m["loss"]), float(m["grad_norm"])),
            "grads": state.opt_state[1],
            "after": {"params": state.params, "batch_stats": state.batch_stats}})
    return initial, batch, want


def test_exact_path_train_step_matches_jax(jax_exact_step):
    """The port's step with ``dysample_window=False`` from JAX's initial
    variables: loss and grad norm within 1e-4 relative, the gradients leaf
    by leaf and the variables after the step as tests/test_torch_train.py
    holds the window path's first step."""
    initial, batch, want = jax_exact_step
    cfg = _small_config(configs.shanghai_km_unet())
    model = engine.build_model(cfg, dysample_window=False)
    assert not model.dec1_up.window
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, device="cpu")
    convert.load_flax(model, initial["params"], initial["batch_stats"])
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.clone() for g in grads]) or update(
        grads, st, params)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    state, m = step(state, batch, None)
    np.testing.assert_allclose((float(m["loss"]), float(m["grad_norm"])), want["metrics"],
                               rtol=1e-4, atol=0)
    zeros = {k: torch.zeros_like(p) for k, p in state.params.items()}
    got_grads = dict(zip(state.params, seen[0]))
    assert float(got_grads["dec3_up.offset.weight"].abs().max()) > 0.0  # through d_x, d_y
    _assert_step_matches(model, tx.lr(0), got_grads,
                         {k: v.clone() for k, v in model.state_dict().items()}, want,
                         (0, zeros, zeros))
