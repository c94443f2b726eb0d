"""The zoo's baselines in training against the JAX package, on the CPU:
the ``rain_loss`` gradients of SCECA-Net, LPTQPN, TransUNet and Swin-UNet
leaf by leaf against ``jax.grad`` of the JAX model, and one step of the
("smaat_unet", "pic") recipe against ``kmunet_tpu.train.engine``.

At 32^2, B=2, 5 -> 4 frames, fp32, tests/test_zoo.py's narrow extras, from
converted perturbed weights (tests/torch_parity.py), BatchNorm on the
batch's statistics, every dropout and stochastic depth at rate 0 (JAX's
masks cannot be drawn in torch; tests/test_torch_zoo.py holds the port's
dropouts by their statistics). The gradients within
tests/test_torch_train.py's step gate: GRAD_RTOL of each leaf's largest,
and the leaves whose exact gradient is 0 (``ZERO_GRADIENT_SUFFIXES``,
and SmaAt's conv biases before a BatchNorm) below ZERO_GRADIENT_SHARE of
the largest gradient. The port's fp32 side runs its convs without oneDNN
(``test_rain_loss_gradients_match_jax``). Each JAX function is
compiled once, at XLA's default optimisation level 3 (the conftest's
level 0 compiles the SmaAt train step to NaN gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.losses.losses import rain_loss as rain_loss_jax
from kmunet_tpu.train import recipes as recipes_jax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.losses import rain_loss
from kmunet_tpu_torch.models import smaat_unet, zoo
from kmunet_tpu_torch.train import engine, recipes
from tests.test_torch_train import (GRAD_RTOL, LATER_STEP_SHARE, ZERO_GRADIENT_SHARE,
                                    _assert_step_matches, _recording)
from tests.test_torch_zoo import extras, no_dense_dropout  # noqa: F401
from tests.torch_parity import init_perturbed, one_torch_thread  # noqa: F401

SIZE, BATCH, OUT = 32, 2, 4
# Leaves whose exact gradient is 0: SRU's gamma behind its hard thresholds
# and its GroupNorm, whose output SRU throws away; the attention's key bias
# (q . (k + b) shifts each query's scores alike, and softmax drops that).
ZERO_GRADIENT_SUFFIXES = (".sru.gamma", ".sru.gn.weight", ".sru.gn.bias", ".attn.key.bias")
LEVEL3 = {"xla_backend_optimization_level": 3}


def _batch(seed):
    """(B, 9, H, W) frames in [0, 1]: 5 inputs, 4 targets."""
    return np.random.default_rng(seed).random((BATCH, 9, SIZE, SIZE), dtype=np.float32)


def _float64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("name", ["sceca_net", "lptqpn", "transunet", "swin_unet"])
def test_rain_loss_gradients_match_jax(name, no_dense_dropout):
    """The loss and every parameter's gradient in training against
    ``jax.grad`` of the JAX model in float64 (``jax.enable_x64``): the port
    in float64 within 1e-6 of each leaf's largest (the same function), the
    fp32 port within the step gate (GRAD_RTOL of each leaf's largest plus
    LATER_STEP_SHARE of the largest gradient of all: TransUNet's position
    embeddings' gradient, 1.0e-3 at most, lies 6.7e-6 from float64 in fp32).
    The fp32 port runs its convs without oneDNN: its fp32 conv backward on
    this CPU lies about 1e-5 of the gradient off, which a train-mode
    BatchNorm's backward (a small residual of its upstream gradient) made
    9.9 % of TransUNet's dec2_conv2 input gradient, 0.9 % of its root
    WSConv's (without oneDNN: 1e-5 and 9e-5). JAX's fp32 BatchNorms are
    the noisier side elsewhere (tests/test_torch_zoo.py), hence the
    float64 reference."""
    from kmunet_tpu.configs import ModelConfig as ModelConfigJax
    from kmunet_tpu.models import zoo as zoo_jax

    batch = _batch(70)
    x, t = batch[:, :5].transpose(0, 2, 3, 1), batch[:, 5:]
    jm = zoo_jax.build(ModelConfigJax(name=name, num_classes=OUT, extra=extras(name)))
    variables = init_perturbed(jm, jnp.zeros((1, SIZE, SIZE, 5)), seed=71)
    stats = variables.get("batch_stats", {})

    def loss(params, stats, x, t):
        out, _ = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return rain_loss_jax(jnp.transpose(out, (0, 3, 1, 2)), t)

    with jax.enable_x64(True):
        want_loss, want = jax.device_get(jax.jit(jax.value_and_grad(loss), compiler_options=LEVEL3)(
            *_float64((variables["params"], stats, x, t))))
    cfg = configs.ModelConfig(name=name, num_classes=OUT, extra=extras(name))
    want_g = convert.to_state_dict(zoo.build(cfg, img_size=SIZE), want, stats)
    largest = max(float(w.abs().max()) for w in want_g.values())
    zero = []
    for dtype in (torch.float32, torch.float64):
        tm = zoo.build(cfg, img_size=SIZE).to(dtype)
        convert.load_flax(tm, variables["params"], stats)
        tm.train()
        with torch.backends.mkldnn.flags(enabled=False):
            got_loss = rain_loss(tm(torch.from_numpy(x).to(dtype)).permute(0, 3, 1, 2),
                                 torch.from_numpy(t).to(dtype))
            got_loss.backward()
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5 if dtype == torch.float32 else 1e-12)
        for key, p in tm.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            w = want_g[key].to(dtype)
            if key.endswith(ZERO_GRADIENT_SUFFIXES):
                zero.append(key)
                assert max(float(g.abs().max()), float(w.abs().max())) <= (
                    ZERO_GRADIENT_SHARE * largest), key
                continue
            err = float((g - w).abs().max())
            if dtype == torch.float32:
                tol = GRAD_RTOL * float(w.abs().max()) + LATER_STEP_SHARE * largest
            else:
                tol = 1e-6 * float(w.abs().max())
            assert err <= tol, (key, dtype, err, float(w.abs().max()), largest)
    assert len(zero) == {"sceca_net": 24, "transunet": 4}.get(name, 0)  # both dtypes


# --- one ("smaat_unet", "pic") step --------------------------------------------


def _small_recipe_config(cfg):
    cfg.data.img_size = SIZE
    cfg.data.batch_size = BATCH
    cfg.data.seq_len = 9
    cfg.data.out_frames = OUT
    cfg.model.num_classes = OUT
    cfg.train.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def jax_smaat_step():
    """JAX's step of the recipe from perturbed parameters and statistics
    (one compile, at level 3), in float64 (``jax.enable_x64``; the recipe's
    fp32 compute dtype casts nothing): the initial variables and the step's
    metrics, gradients and variables after it. JAX's fp32 step lies 1.7e-4
    from it in the grad norm, where the port's fp32 step lies within the
    gate (the BatchNorms' one-pass fp32 sums, tests/test_torch_zoo.py)."""
    cfg = _small_recipe_config(recipes_jax.apply_recipe(configs_jax.shanghai_km_unet(),
                                                        "smaat_unet", "pic"))
    model = engine_jax.build_model(cfg)
    variables = init_perturbed(model, jnp.zeros((1, SIZE, SIZE, 5)), seed=72)
    tx = _recording(engine_jax.build_optimizer(cfg, steps_per_epoch=10))
    with jax.enable_x64(True):
        params, stats = _float64((variables["params"], variables["batch_stats"]))
        state = engine_jax.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params))
        step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                       compiler_options=LEVEL3)
        state, m = step(state, np.asarray(_batch(73), np.float64), jax.random.PRNGKey(3))
        want = jax.device_get({"metrics": (float(m["loss"]), float(m["grad_norm"])),
                               "grads": state.opt_state[1],
                               "after": {"params": state.params,
                                         "batch_stats": state.batch_stats}})
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert np.isfinite(want["metrics"]).all()
    return variables, want


def test_smaat_recipe_step_matches_jax(jax_smaat_step):
    """One step of ("smaat_unet", "pic") (SGD lr 1e-2, momentum 0.9,
    coupled decay 1e-4, ``rain_loss``, CosineAnnealingLR) through the
    port's engine: the loss and grad norm within 1e-4 relative, the
    gradients in the step gate (with LATER_STEP_SHARE, as
    ``test_rain_loss_gradients_match_jax``), the parameters and the BatchNorm running
    statistics after it within 1e-4 plus what the two gradients' difference
    makes of SGD's first update (``_assert_step_matches``). JAX's step is
    the float64 reference (``jax_smaat_step``)."""
    initial, want = jax_smaat_step
    cfg = _small_recipe_config(recipes.apply_recipe(configs.shanghai_km_unet(),
                                                    "smaat_unet", "pic"))
    model = engine.build_model(cfg)
    assert isinstance(model, smaat_unet.SmaAt_UNet)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    assert (type(tx).__name__, tx.momentum, tx.l2) == ("SGD", 0.9, 1e-4)
    state = engine.init_state(cfg, model, tx, device="cpu")
    assert len(state.batch_stats) == 2 * (2 * 9 + 5)  # 9 DoubleConvDS, 5 CBAM
    convert.load_flax(model, initial["params"], initial["batch_stats"])
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.clone() for g in grads]) or update(
        grads, st, params)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    assert engine.build_loss(cfg) is rain_loss
    with torch.backends.mkldnn.flags(enabled=False):
        state, m = step(state, _batch(73), None)
    np.testing.assert_allclose((float(m["loss"]), float(m["grad_norm"])), want["metrics"],
                               rtol=1e-4, atol=0)
    _assert_step_matches(model, tx.lr(0), dict(zip(state.params, seen[0])),
                         {k: v.clone() for k, v in model.state_dict().items()}, want,
                         (0, {}, {}), share=LATER_STEP_SHARE, update=lambda g: g,
                         zero=_before_batch_norm)
    assert state.step == 1 and state.opt_state.count == 1


def _before_batch_norm(key: str) -> bool:
    """The conv biases of SmaAt's DoubleConvDS: each feeds a train-mode
    BatchNorm (the depthwise one through the 1x1 pointwise conv), which
    takes the batch's mean away, so their exact gradient is 0 (JAX's
    float64 one is 4e-15 at most)."""
    return key.startswith("DoubleConvDS_") and key.endswith(("depthwise.bias", "pointwise.bias"))
