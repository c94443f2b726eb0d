"""The port's train step under every option the JAX engine takes, on the
CPU, at the 32^2, B=8 (B=2 for the builds), 9-frame, 4-output config of
tests/test_sharding_parity.py.

``remat`` recomputes the forward in the backward; with stochastic depth on
(drop_path 0.2, the caller's generator) the remat step must give the step
without it: gradients within 1e-6 of each leaf's largest |gradient| (on
the CPU they come out bit-equal), the same parameters and BatchNorm running
buffers after the update (moved once), and the generator left in the same
state. Each option that the port refused before (each optimizer, schedule,
``grad_clip``, ``wd_mask_norms``, ``remat``, ``kan_reg_weight`` and the
``mse`` loss) builds a step that trains. ``kan_reg_weight`` adds the
regularizer of the fp32 master parameters, and ``mse`` is JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu_torch import configs
from kmunet_tpu_torch.nn.kan import kan_regularization_loss
from kmunet_tpu_torch.train import engine, optimizers

REMAT_RTOL = 1e-6  # of each leaf's largest |gradient|


def _small_config(batch=8, drop_path=0.2, dtype="float32", **train):
    cfg = configs.shanghai_km_unet()
    cfg.data.img_size, cfg.data.batch_size = 32, batch
    cfg.data.seq_len, cfg.data.out_frames = 9, 4
    cfg.model.num_classes = 4
    cfg.model.extra["drop_path"] = drop_path
    cfg.train.compute_dtype = dtype
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _batch(batch=8, seed=7):
    return np.random.default_rng(seed).random((batch, 9, 32, 32), dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The 32^2 steps are small: one intra-op thread runs them about as fast
    alone and does not contend with the other test workers' threads (with
    eight per worker this file took 20 minutes in the tier-1 run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def initial():
    """The seeded init's weights (one init for the file: it costs a second)."""
    cfg = _small_config()
    model = engine.build_model(cfg)
    engine.init_state(cfg, model, engine.build_optimizer(cfg, 10), seed=0, device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def _setup(cfg, initial, dysample_window=True, steps_per_epoch=10):
    """(model, tx, state) of ``cfg`` from the ``initial`` weights, on the CPU
    in training mode, as ``engine.init_state`` makes them."""
    model = engine.build_model(cfg, dysample_window=dysample_window)
    model.load_state_dict(initial)
    model.train()
    tx = engine.build_optimizer(cfg, steps_per_epoch=steps_per_epoch)
    params = dict(model.named_parameters())
    stats = {k: b for k, b in model.named_buffers() if not k.endswith("num_batches_tracked")}
    return model, tx, engine.TrainState(0, params, stats, tx.init(list(params.values())))


def _one_step(cfg, initial, dysample_window=True):
    """One step from ``initial`` with a fresh generator: the gradients the
    optimizer took, the state_dict after it, the generator's state (and
    the state it started from) and the metrics."""
    model, tx, state = _setup(cfg, initial, dysample_window)
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.clone() for g in grads]) or update(
        grads, st, params)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    gen = torch.Generator().manual_seed(3)
    start = gen.get_state()
    _, m = step(state, _batch(cfg.data.batch_size), gen)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(zip(state.params, seen[0])), after, gen.get_state(), start, m


@pytest.mark.parametrize("dtype,window", [("float32", True), ("float32", False),
                                          ("bfloat16", True)],
                         ids=["fp32-window", "fp32-exact", "bf16-window"])
def test_remat_step_equals_the_step_without_remat(initial, dtype, window):
    """With every option on (kan_reg_weight, grad_clip, wd_mask_norms): the
    remat step replays DropPath's generator and moves the BatchNorm
    statistics once, through DySample's window or exact path (the K4 and K6
    plain versions here)."""
    options = dict(kan_reg_weight=1e-3, grad_clip=1.0, wd_mask_norms=True)
    plain = _one_step(_small_config(dtype=dtype, **options), initial, window)
    remat = _one_step(_small_config(dtype=dtype, remat=True, **options), initial, window)
    (g0, after0, gen0, start, m0), (g1, after1, gen1, _, m1) = plain, remat
    assert not torch.equal(gen0, start)  # stochastic depth drew from the generator
    assert torch.equal(gen1, gen0)
    torch.testing.assert_close(m1["loss"], m0["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(m1["grad_norm"], m0["grad_norm"], rtol=1e-6, atol=0)
    for k, g in g0.items():
        err = float((g1[k] - g).abs().max())
        assert err <= REMAT_RTOL * float(g.abs().max()), (k, err)
    moved = 0
    for k, v in after0.items():
        torch.testing.assert_close(after1[k], v, rtol=0, atol=REMAT_RTOL * float(v.abs().max()),
                                   msg=k)
        moved += k.endswith("running_mean") and not torch.equal(v, torch.zeros_like(v))
    assert moved > 0


# Each option the port took on with the JAX engine's surface, as
# (train config fields): the optimizers (rprop at a constant lr), the
# schedules, the chain's stages, remat, the KAN regularizer and mse.
OPTIONS = {
    **{f"optimizer-{name}": {"optimizer": name}
       for name in ("adadelta", "adagrad", "adamax", "asgd", "rmsprop")},
    "optimizer-rprop": {"optimizer": "rprop", "schedule": "constant"},
    **{f"schedule-{name}": {"schedule": name}
       for name in ("StepLR", "ExponentialLR", "CosineAnnealingWarmRestarts", "WP_MultiStepLR",
                    "WP_CosineLR", "constant", "plateau")},
    "grad_clip": {"grad_clip": 0.5},
    "wd_mask_norms": {"wd_mask_norms": True},
    "wd_mask_norms-rprop": {"wd_mask_norms": True, "optimizer": "rprop",
                            "schedule": "constant"},
    "remat": {"remat": True},
    "kan_reg_weight": {"kan_reg_weight": 1e-3},
    "loss-mse": {"loss": "mse"},
}


# The options whose first update is 0: the warm-up schedules' lr in epoch
# 0, and rprop's (optax applies the previous step's step size).
STILL_AT_FIRST_STEP = ("optimizer-rprop", "schedule-WP_MultiStepLR", "schedule-WP_CosineLR",
                       "wd_mask_norms-rprop")


@pytest.mark.parametrize("option", list(OPTIONS))
def test_step_builds_and_trains_with_each_option(initial, option):
    """One step at B=2 (two, one epoch each, where the first update is 0):
    finite losses and grad norms, and the parameters move."""
    cfg = _small_config(batch=2, **OPTIONS[option])
    model, tx, state = _setup(cfg, initial, steps_per_epoch=1)
    before = [p.detach().clone() for p in state.params.values()]
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    gen = torch.Generator().manual_seed(1)
    steps = 2 if option in STILL_AT_FIRST_STEP else 1
    metrics = []
    for i in range(steps):
        state, m = step(state, _batch(2, seed=i), gen)
        metrics.append(m)
    assert np.isfinite([float(m[k]) for m in metrics for k in ("loss", "grad_norm")]).all()
    assert state.opt_state.count == steps
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(state.params.values(), before))
    assert moved > 0.0


def test_kan_reg_weight_adds_the_regularizer_of_the_fp32_parameters(initial):
    """In bf16 compute the regularizer reads the fp32 master parameters (as
    JAX's ``kan_regularization_loss(params)``), not their bf16 copies."""
    cfg, reg_cfg = (_small_config(batch=2, drop_path=0.0, dtype="bfloat16", kan_reg_weight=w)
                    for w in (0.0, 0.25))
    model, _, state = _setup(cfg, initial)
    batch = torch.from_numpy(_batch(2))
    loss_fn = engine.build_loss(cfg)
    base = engine.make_loss_of(model, loss_fn, cfg)(state.params, batch)
    with_reg = engine.make_loss_of(model, loss_fn, reg_cfg)(state.params, batch)
    reg = kan_regularization_loss(state.params)
    reg_bf16 = kan_regularization_loss({k: p.bfloat16() for k, p in state.params.items()})
    reg, reg_bf16 = reg.detach(), reg_bf16.detach()
    assert float(reg) > 0 and float((reg - reg_bf16).abs()) > 1e-6 * float(reg)
    torch.testing.assert_close(with_reg, base + 0.25 * reg, rtol=1e-6, atol=0)


def test_mse_loss_matches_jax():
    p = np.random.default_rng(1).uniform(size=(2, 4, 8, 8)).astype(np.float32)
    t = np.random.default_rng(2).uniform(size=(2, 4, 8, 8)).astype(np.float32)
    jax_cfg = configs_jax.shanghai_km_unet()
    jax_cfg.train.loss = "mse"
    want, want_grad = jax.value_and_grad(
        lambda a: engine_jax.build_loss(jax_cfg)(a, jnp.asarray(t)))(jnp.asarray(p))
    cfg = configs.shanghai_km_unet()
    cfg.train.loss = "mse"
    p_t = torch.from_numpy(p).requires_grad_()
    got = engine.build_loss(cfg)(p_t, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-10)


def test_plateau_scale_lives_in_the_optimizer_state(initial):
    """``schedule="plateau"``: the step's update is scaled by
    ``state.opt_state.scale``, which ``PlateauScheduler`` sets."""
    cfg = _small_config(batch=2, drop_path=0.0, schedule="plateau")
    model, tx, state = _setup(cfg, initial)
    assert isinstance(state.opt_state, optimizers.ChainState) and state.opt_state.scale == 1.0
    controller = optimizers.PlateauScheduler(factor=0.5, patience=0)
    state.opt_state.scale = [controller.update(m) for m in (1.0, 1.0)][-1]
    assert state.opt_state.scale == 0.5
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    state, _ = step(state, _batch(2), None)
    assert state.opt_state.scale == 0.5 and state.opt_state.count == 1
