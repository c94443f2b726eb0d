"""The port's optimizers, schedules and ``build_optimizer`` against the JAX
package's (``kmunet_tpu/train/optimizers.py``, ``train/engine.py``), on the
CPU.

Every optimizer of ``make_optimizer``, with and without weight decay, takes
three updates of a seeded parameter dict under a schedule that changes
between them (rprop: its constant learning rate) and must land within 1e-6
of each leaf's largest |value| of optax's. Every schedule is held to JAX's
at every epoch 0-1,300 (``SCHEDULE_TOL``); the warm restarts land in the
same cycle at every epoch. ``PlateauScheduler``
follows the JAX class on a fixed metric sequence. ``build_optimizer``'s
chain (grad_clip, wd_mask_norms, plateau) is held to JAX's on the same
parameters, and both refuse rprop under a schedule.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.train import optimizers as optimizers_jax
from kmunet_tpu_torch import configs
from kmunet_tpu_torch.train import engine, optimizers
from kmunet_tpu_torch.train.schedule import make_schedule

SHAPES = {"conv": (3, 3, 2, 4), "dense": (5, 3), "scale": (4,), "bias": (3,), "alpha": ()}
PARAM_RTOL = 1e-6  # of each leaf's largest |value|


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed, n=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return [{k: np.asarray(scale * rng.normal(size=s), np.float32) for k, s in SHAPES.items()}
            for _ in range(n)]


def _run_jax(tx, params, grads, set_scale=None):
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    if set_scale is not None:
        state[-1].hyperparams["step_size"] = jnp.asarray(set_scale, jnp.float32)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_port(tx, params, grads, set_scale=None):
    p = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    state = tx.init(p)
    if set_scale is not None:
        state.scale = set_scale
    for g in grads:
        state = tx.update([torch.from_numpy(g[k]) for k in SHAPES], state, p)
    assert state.count == len(grads)
    return {k: t.numpy() for k, t in zip(SHAPES, p)}


def _assert_params_match(got, want):
    for k in SHAPES:
        tol = PARAM_RTOL * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


# (name, make_optimizer keywords) of every optimizer of the factory and its
# variants: SGD with nesterov and without momentum, RMSprop centered and
# without momentum.
OPTIMIZERS = [("adadelta", {}), ("adagrad", {}), ("adam", {}), ("adamw", {}), ("adamax", {}),
              ("asgd", {}), ("rmsprop", {}), ("rmsprop", {"centered": True}),
              ("rmsprop", {"momentum": 0.0}), ("rmsprop", {"centered": True, "momentum": 0.0}),
              ("rprop", {}), ("sgd", {}), ("sgd", {"nesterov": True}),
              ("sgd", {"momentum": 0.0})]


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(k) or 'default'}" for n, k in OPTIMIZERS])
def test_optimizer_matches_optax(name, kwargs, weight_decay):
    """Three updates under a MultiStepLR that halves the lr after each
    (rprop: a constant lr, its initial step size; optax's rprop applies the
    previous step's signed step size, so its first update is 0)."""
    params, grads = _params(0), _grads(1)
    if name == "rprop":
        lr_jax = lr_port = 1e-2
    else:
        lr_jax = optimizers_jax.make_schedule("MultiStepLR", 1e-2, 1, milestones=(1, 2),
                                              gamma=0.5)
        lr_port = make_schedule("MultiStepLR", 1e-2, 1, milestones=(1, 2), gamma=0.5)
    want = _run_jax(optimizers_jax.make_optimizer(name, lr_jax, weight_decay=weight_decay,
                                                  **kwargs), params, grads)
    tx = optimizers.make_optimizer(name, lr_port, weight_decay=weight_decay, **kwargs)
    got = _run_port(tx, params, grads)
    _assert_params_match(got, want)
    assert any(not np.array_equal(got[k], params[k]) for k in SHAPES)


def test_unknown_optimizer_and_schedule_raise_as_in_jax():
    for make in (optimizers_jax.make_optimizer, optimizers.make_optimizer):
        with pytest.raises(ValueError, match="unsupported optimizer"):
            make("lbfgs", 1e-3)
    for make in (optimizers_jax.make_schedule, make_schedule):
        with pytest.raises(ValueError, match="unsupported scheduler"):
            make("OneCycleLR", 1e-3, 10)


# (name, keywords) of every schedule of make_schedule; the warm restarts
# with t_mult 1, 2 and 3 (epoch 1210 starts a cycle of t_0 10, t_mult 3).
SCHEDULES = [("StepLR", {"step_size": 7, "gamma": 0.5}), ("StepLR", {}),
             ("MultiStepLR", {"milestones": (30, 200, 900), "gamma": 0.3}),
             ("ExponentialLR", {"gamma": 0.99}), ("ExponentialLR", {}),
             ("CosineAnnealingLR", {"t_max": 50, "eta_min": 1e-5}),
             ("CosineAnnealingWarmRestarts", {"t_mult": 1}),
             ("CosineAnnealingWarmRestarts", {}),
             ("CosineAnnealingWarmRestarts", {"t_mult": 3, "eta_min": 1e-5}),
             ("WP_MultiStepLR", {"milestones": (30, 200)}),
             ("WP_CosineLR", {"epochs": 300, "warm_up_epochs": 10}),
             ("constant", {})]
EPOCHS = 1301


def schedule_tol(epochs, want, base):
    """JAX evaluates the schedules in fp32, the port in float64. Beside an
    fp32 rounding of the value (1e-6 relative; 1e-7 of the base lr where
    it nears 0 or underflows fp32), JAX rounds its inputs: gamma (0.99 by
    9.6e-9 relative, compounded once per epoch in gamma ** e) and the
    cosines' argument pi * e / t_max, whose error grows with e (3.6e-6 of
    the base lr at epoch 1300 for t_max 50). Both stay under 1e-8 * e of
    the base lr."""
    return 1e-6 * np.abs(want) + base * (1e-7 + 1e-8 * epochs)


@pytest.mark.parametrize("name,kwargs", SCHEDULES,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in SCHEDULES])
def test_schedule_matches_jax_at_every_epoch(name, kwargs):
    base = 1e-3
    port = make_schedule(name, base, 1, **kwargs)
    ref = optimizers_jax.make_schedule(name, base, 1, **kwargs)
    if name == "constant":
        assert port == ref == base
        return
    want = np.asarray(jax.jit(jax.vmap(ref))(jnp.arange(EPOCHS, dtype=jnp.int32)))
    got = np.array([port(e) for e in range(EPOCHS)])
    err = np.abs(got - want)
    assert (err <= schedule_tol(np.arange(EPOCHS), want, base)).all(), (err.max(), err.argmax())
    # Stepped per epoch: steps of one epoch share its lr.
    per3 = make_schedule(name, base, 3, **kwargs)
    assert [per3(s) for s in range(30)] == [port(s // 3) for s in range(30)]


def test_warm_restart_cycles_are_exact():
    """At t_0 10, t_mult 3 epoch 1210 starts the sixth cycle: the lr is the
    base lr, as in JAX's fp32 arithmetic; the closed form in float64 puts
    the epoch at the end of the fifth cycle (eta_min)."""
    port = make_schedule("CosineAnnealingWarmRestarts", 1.0, 1, t_mult=3, eta_min=0.0)
    ref = optimizers_jax.make_schedule("CosineAnnealingWarmRestarts", 1.0, 1, t_mult=3)
    assert port(1210) == 1.0 == float(ref(jnp.int32(1210)))
    k64 = math.floor(math.log(1210 / 10 * 2 + 1) / math.log(3))
    assert k64 == 4  # float64's closed form is one cycle short
    starts = [e for e in range(1, EPOCHS) if port(e) == 1.0]
    assert starts == [10, 40, 130, 400, 1210]


def test_plateau_scheduler_matches_jax():
    metrics = [1.0, 0.9, 0.9, 0.95, 0.91, 0.92, 0.8999, 0.93, 0.89, 0.9, 0.9, 0.9, 0.9,
               0.88, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95] + [1.0] * 40
    port = optimizers.PlateauScheduler(factor=0.5, patience=2)
    ref = optimizers_jax.PlateauScheduler(factor=0.5, patience=2)
    got = [port.update(m) for m in metrics]
    assert got == [ref.update(m) for m in metrics]
    assert (port.best, port.bad) == (ref.best, ref.bad)
    assert min(got) < 1e-3  # the scale fell several times
    tiny = optimizers.PlateauScheduler(factor=1e-3, patience=0, min_scale=1e-8)
    assert [tiny.update(1.0) for _ in range(5)][-1] == 1e-8  # floored at min_scale


def _configs(**train):
    port, ref = configs.shanghai_km_unet(), configs_jax.shanghai_km_unet()
    for cfg in (port, ref):
        for k, v in train.items():
            setattr(cfg.train, k, v)
    return port, ref


# (train config fields, gradient scale, the plateau's scale): the SH
# recipe (AdamW, per-epoch cosine) with grad_clip 1.0 under and over the
# clip (global norms about 0.3 and 50), wd_mask_norms for adamw, sgd and
# rprop, and the plateau at the scale 0.1.
BUILD_CASES = {
    "clip-below": ({"grad_clip": 1.0}, 0.03, None),
    "clip-above": ({"grad_clip": 1.0}, 5.0, None),
    "mask-adamw": ({"wd_mask_norms": True}, 1.0, None),
    "mask-sgd": ({"wd_mask_norms": True, "optimizer": "sgd"}, 1.0, None),
    "mask-rprop": ({"wd_mask_norms": True, "optimizer": "rprop", "schedule": "constant"}, 1.0,
                   None),
    "plateau": ({"schedule": "plateau"}, 1.0, 0.1),
    "all-sgd": ({"grad_clip": 1.0, "wd_mask_norms": True, "optimizer": "sgd",
                 "schedule": "plateau"}, 5.0, 0.1),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_optimizer_matches_jax(case):
    train, grad_scale, set_scale = BUILD_CASES[case]
    port_cfg, jax_cfg = _configs(**train)
    params, grads = _params(2), _grads(3, scale=grad_scale)
    norms = [math.sqrt(sum(float((g ** 2).sum()) for g in gs.values())) for gs in grads]
    if "clip" in case:  # on one side of the clip, well away from it
        assert all((n < 0.5) if case == "clip-below" else (n > 2.0) for n in norms), norms
    want = _run_jax(engine_jax.build_optimizer(jax_cfg, 1), params, grads, set_scale)
    tx = engine.build_optimizer(port_cfg, 1)
    got = _run_port(tx, params, grads, set_scale)
    _assert_params_match(got, want)
    if case == "mask-rprop":  # the masked decay reaches rprop, which has none of its own
        no_mask, _ = _configs(optimizer="rprop", schedule="constant")
        plain = _run_port(engine.build_optimizer(no_mask, 1), params, grads)
        assert not np.array_equal(plain["conv"], got["conv"])
        np.testing.assert_array_equal(plain["bias"], got["bias"])
    if set_scale is not None:  # the scale moved the step
        unscaled = _run_port(engine.build_optimizer(port_cfg, 1), params, grads)
        step = np.abs(got["dense"] - params["dense"]).max()
        assert 0 < step < 0.5 * np.abs(unscaled["dense"] - params["dense"]).max()


def test_build_optimizer_without_options_is_the_factory_optimizer():
    cfg = configs.shanghai_km_unet()
    assert type(engine.build_optimizer(cfg, 10)) is optimizers.AdamW
    for field, value in [("grad_clip", 1.0), ("wd_mask_norms", True)]:
        opt = configs.shanghai_km_unet()
        setattr(opt.train, field, value)
        tx = engine.build_optimizer(opt, 10)
        assert isinstance(tx, optimizers.Chain if field == "grad_clip" else optimizers.AdamW)
    assert engine.build_optimizer(_configs(schedule="plateau")[0], 10).init([]).scale == 1.0


def test_rprop_with_a_schedule_is_refused_on_both_sides():
    """optax's rprop takes a float lr: JAX's factory builds it, and making
    its state fails (TypeError); the port refuses it when it is built, in
    the factory and in build_optimizer under the default per-epoch
    cosine."""
    params = jax.tree.map(jnp.asarray, _params(0))
    sched = optimizers_jax.make_schedule("StepLR", 1e-3, 10)
    with pytest.raises(TypeError):
        optimizers_jax.make_optimizer("rprop", sched).init(params)
    port_cfg, jax_cfg = _configs(optimizer="rprop")
    with pytest.raises(TypeError):
        engine_jax.build_optimizer(jax_cfg, 10).init(params)
    with pytest.raises(ValueError, match="rprop takes a constant learning rate"):
        optimizers.make_optimizer("rprop", make_schedule("StepLR", 1e-3, 10))
    with pytest.raises(ValueError, match="rprop takes a constant learning rate"):
        engine.build_optimizer(port_cfg, 10)
    for schedule in ("constant", "plateau"):
        engine.build_optimizer(_configs(optimizer="rprop", schedule=schedule)[0], 10)
