"""One ``laps_km_unet()`` train step of the port against the JAX engine, on
the CPU: 32^2, B=1 as the recipe's, seq 8 -> 3 outputs, no stochastic
depth, fp32, from perturbed variables, held as tests/test_torch_train.py
holds the SH step (its checks, imported). Apart from
tests/test_torch_laps.py so that each file's JAX compiles stay small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.train import engine
from tests.test_torch_train import _assert_step_matches, _recording
from tests.torch_parity import init_perturbed


def _small_laps(cfg):
    """``laps_km_unet()`` at 32^2, fp32, no stochastic depth (seq 8 -> 3 at
    the recipe's B=1)."""
    cfg.data.img_size = 32
    cfg.model.extra["drop_path"] = 0.0
    cfg.train.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def jax_laps_step():
    """One step of the JAX engine on ``laps_km_unet()`` from perturbed
    variables (``init_perturbed``: shapes only; the module's own init, jitted
    or not, costs far more), compiled once at XLA's default optimisation
    level (3): the initial variables, and the step's metrics, gradients and
    variables after it."""
    cfg = _small_laps(configs_jax.laps_km_unet())
    model = engine_jax.build_model(cfg)
    tx = _recording(engine_jax.build_optimizer(cfg, steps_per_epoch=10))
    variables = jax.tree_util.tree_map(
        jnp.asarray, init_perturbed(model, jnp.zeros((1, 32, 32, 5)), seed=10))
    state = engine_jax.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]))
    initial = jax.device_get(variables)
    step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                   compiler_options={"xla_backend_optimization_level": 3})
    batch = np.random.default_rng(8).random((1, 8, 32, 32), dtype=np.float32)
    state, m = step(state, jnp.asarray(batch), jax.random.PRNGKey(3))
    want = jax.device_get({
        "metrics": (float(m["loss"]), float(m["grad_norm"])),
        "grads": state.opt_state[1],
        "after": {"params": state.params, "batch_stats": state.batch_stats}})
    assert np.isfinite(want["metrics"]).all()
    return initial, batch, want


def test_laps_train_step_matches_jax(jax_laps_step):
    """The port's ``laps_km_unet()`` step from JAX's initial variables: loss
    and grad norm within 1e-4 relative, the gradients leaf by leaf and the
    variables after the step as tests/test_torch_train.py holds the SH
    step's first."""
    initial, batch, want = jax_laps_step
    cfg = _small_laps(configs.laps_km_unet())
    model = engine.build_model(cfg)
    assert model.variant == "laps"
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
    _assert_step_matches(model, tx.lr(0), dict(zip(state.params, seen[0])),
                         {k: v.clone() for k, v in model.state_dict().items()}, want,
                         (0, zeros, zeros))
