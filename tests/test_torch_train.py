"""The port's training step against the JAX package, on the CPU.

Train-mode modules (``DeformConv2d``, ``ConvBNAct``, ``DAGEM``) run with
converted, perturbed weights (tests/torch_parity.py): outputs, input, offset
and parameter gradients and the updated BatchNorm statistics within 1e-4 abs
(the per-layer bound of BASELINE.json), fp32. The bf16 deformable conv must
build its sampling coordinates in bf16 as the JAX package does. The loss,
the schedule, AdamW, the configs and the synthetic data are held to theirs,
and the whole SH train step to ``kmunet_tpu.train.engine.make_train_step``
over 2 steps at the small config of tests/test_sharding_parity.py (B cut to
2, fp32, no stochastic depth): losses and grad norms within 1e-4 relative,
the first step's gradients leaf by leaf, and the parameters and BatchNorm
statistics after it within 1e-4 abs. The second step starts from JAX's state
after the first (parameters, statistics and AdamW's moments and count) and is
held to the same bounds. The first step with the image rows sharded over two
gloo ranks (``mesh.spatial`` = 2) is held to the same JAX step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.data.synthetic as synthetic_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.losses.losses import hybrid_loss as hybrid_loss_jax
from kmunet_tpu.nn import dagem as dagem_jax
from kmunet_tpu.nn import layers as layers_jax
from kmunet_tpu.ops.ssim import ssim_valid as ssim_valid_jax
from kmunet_tpu.train.schedule import cosine_annealing_per_epoch as cosine_jax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.data import SyntheticNowcastDataset
from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.losses import hybrid_loss
from kmunet_tpu_torch.nn import dagem, layers, resample
from kmunet_tpu_torch.ops.ssim import ssim_valid
from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.optimizers import AdamW, OptState
from kmunet_tpu_torch.train.schedule import cosine_annealing_per_epoch
from tests.torch_parity import init_perturbed, nchw, nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests import torch_ranks, torch_rows

ATOL = 1e-4


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _train_mode(module, variables):
    convert.load_flax(module, variables["params"], variables.get("batch_stats"))
    return module.train()


def _assert_grads_match(module, want_params_grads, want_stats):
    """The port's parameter grads and running stats against JAX's, mapped to
    state_dict names by the converter."""
    want = convert.to_state_dict(module, want_params_grads, want_stats)
    got = {**{k: p.grad for k, p in module.named_parameters()}, **dict(module.named_buffers())}
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].detach().numpy(), w.numpy(), rtol=0, atol=ATOL,
                                   err_msg=key)


def test_deform_conv_train_gradients_match_jax():
    """Output and the gradients to x, offset, weight and bias, fp32."""
    x = _normal((2, 8, 8, 6), 0)
    offset = _normal((2, 8, 8, 18), 1, scale=1.5)
    g = _normal((2, 8, 8, 5), 2)
    jm = resample_jax.DeformConv2d(5)
    variables = init_perturbed(jm, jnp.asarray(x), jnp.asarray(offset), seed=1)
    out, vjp = jax.vjp(lambda p, a, o: jm.apply({"params": p}, a, o),
                       variables["params"], jnp.asarray(x), jnp.asarray(offset))
    d_params, d_x, d_off = vjp(jnp.asarray(g))
    tm = _train_mode(resample.DeformConv2d(6, 5), variables)
    x_t, off_t = torch.from_numpy(x).requires_grad_(), torch.from_numpy(offset).requires_grad_()
    got = tm(x_t, off_t)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(d_x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(off_t.grad.numpy(), np.asarray(d_off), rtol=0, atol=ATOL)
    _assert_grads_match(tm, d_params, None)


def test_deform_conv_bf16_coordinates_match_jax():
    """bf16 forward at 16x16 with N(0, 1) offsets against the JAX bf16
    forward, within 2 bf16 ulps of the output's scale. The coordinates must
    be built in bf16, in the JAX order of additions: built in fp32 they land
    up to 1/32 px elsewhere near coordinate 15, and the outputs differ by
    about 6 ulps."""
    x = _normal((2, 16, 16, 8), 3)
    offset = _normal((2, 16, 16, 18), 4)
    jm = resample_jax.DeformConv2d(8)
    variables = init_perturbed(jm, jnp.asarray(x), jnp.asarray(offset), seed=2)
    vb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    want = np.asarray(jm.apply(vb, jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(offset, jnp.bfloat16)).astype(jnp.float32))
    tm = convert.load_flax(resample.DeformConv2d(8, 8), variables["params"]).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16(), torch.from_numpy(offset).bfloat16()).float()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("groups", [1, 6])
def test_conv_bn_act_train_matches_jax(groups):
    """flax's train-mode BatchNorm: biased batch variance, and the running
    statistics moved by 0.1 towards the batch's (biased) ones."""
    x = _normal((3, 5, 5, 6), 5)
    g = _normal((3, 5, 5, 6), 6)
    jm = layers_jax.ConvBNAct(6, (3, 3), groups=groups)
    variables = init_perturbed(jm, jnp.asarray(x), seed=3, train=False)

    def fwd(p, a):
        return jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, a, train=True,
                        mutable=["batch_stats"])

    out, vjp, mutated = jax.vjp(fwd, variables["params"], jnp.asarray(x), has_aux=True)
    d_params, d_x = vjp(jnp.asarray(g))
    tm = _train_mode(layers.ConvBNAct(6, 6, (3, 3), groups=groups), variables)
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    _assert_grads_match(tm, d_params, mutated["batch_stats"])


def test_dagem_train_matches_jax():
    """DAGEM in training: output, input gradient, every parameter gradient
    (the offset conv's through the K6 plain backward) and the updated
    statistics of its five BatchNorms."""
    x = _normal((2, 8, 8, 16), 7)
    g = _normal((2, 8, 8, 16), 8)
    jm = dagem_jax.DAGEM()
    variables = init_perturbed(jm, jnp.asarray(x), seed=4, train=False)

    def fwd(p, a):
        return jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, a, train=True,
                        mutable=["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)  # XLA gather on the CPU
        out, vjp, mutated = jax.vjp(fwd, variables["params"], jnp.asarray(x), has_aux=True)
        d_params, d_x = vjp(jnp.asarray(g))
    tm = _train_mode(dagem.DAGEM(16), variables)
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    assert float(tm.offset_conv.weight.grad.abs().max()) > 1e-3  # the deform branch learns
    _assert_grads_match(tm, d_params, mutated["batch_stats"])


def test_drop_path_in_training():
    """One Bernoulli(keep) draw per sample, kept samples scaled by 1/keep,
    the same output for the same generator seed, the identity in eval."""
    dp = layers.DropPath(0.5).train()
    x = torch.from_numpy(_normal((64, 3, 4, 4), 9))
    y = dp(x, torch.Generator().manual_seed(1))
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())  # whole samples, never parts
    n_kept = int(kept.all(1).sum())
    assert 16 < n_kept < 48
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / 0.5, rtol=0, atol=0)
    torch.testing.assert_close(dp(x, torch.Generator().manual_seed(1)), y, rtol=0, atol=0)
    assert not torch.equal(dp(x, torch.Generator().manual_seed(2)), y)
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    assert dp.eval()(x) is x
    assert layers.DropPath(0.0).train()(x) is x


def test_ssim_valid_value_and_gradient_match_jax():
    p = np.random.default_rng(10).uniform(size=(2, 3, 20, 17)).astype(np.float32)
    t = np.random.default_rng(11).uniform(size=(2, 3, 20, 17)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: ssim_valid_jax(a, jnp.asarray(t), data_range=1.0),
                        jnp.asarray(p))
    g = _normal((2, 3), 12)
    (want_grad,) = vjp(jnp.asarray(g))
    p_t = torch.from_numpy(p).requires_grad_()
    got = ssim_valid(p_t, torch.from_numpy(t), data_range=1.0)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


def test_hybrid_loss_value_and_gradient_match_jax():
    p = np.random.default_rng(13).uniform(size=(2, 4, 24, 24)).astype(np.float32)
    t = np.random.default_rng(14).uniform(size=(2, 4, 24, 24)).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda a: hybrid_loss_jax(a, jnp.asarray(t), alpha=0.7))(jnp.asarray(p))
    p_t = torch.from_numpy(p).requires_grad_()
    got = hybrid_loss(p_t, torch.from_numpy(t), alpha=0.7)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-9)


def test_cosine_schedule_matches_jax_over_three_epochs():
    port = cosine_annealing_per_epoch(1e-3, 5e-4, 200, steps_per_epoch=4)
    ref = cosine_jax(1e-3, 5e-4, 200, steps_per_epoch=4)
    steps = range(12)
    np.testing.assert_allclose([port(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6)
    assert port(3) == port(0) > port(4)  # stepped per epoch


def test_adamw_steps_match_optax():
    """Three steps on a small pytree with the SH recipe's settings and a
    stepped schedule: the lr is read at the count before each update."""
    rng = np.random.default_rng(15)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    sched = cosine_jax(1e-3, 5e-4, 2, steps_per_epoch=1)
    tx = optax.adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05)
    p_jax = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p_jax)
    port_tx = AdamW(cosine_annealing_per_epoch(1e-3, 5e-4, 2, 1), weight_decay=0.05)
    p_port = [torch.from_numpy(params[k].copy()) for k in shapes]
    state = port_tx.init(p_port)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        state = port_tx.update([torch.from_numpy(g[k]) for k in shapes], state, p_port)
    assert state.count == 3
    for k, p in zip(shapes, p_port):
        np.testing.assert_allclose(p.numpy(), np.asarray(p_jax[k]), rtol=0, atol=1e-7)


def test_config_defaults_match_jax():
    """The port's copy of the configs: the JAX package's fields, each with
    its default, in every config and in both recipes."""
    pairs = [(configs.DataConfig(), configs_jax.DataConfig()),
             (configs.ModelConfig(), configs_jax.ModelConfig()),
             (configs.TrainConfig(), configs_jax.TrainConfig()),
             (configs.MeshConfig(), configs_jax.MeshConfig())]
    for recipe in ("shanghai_km_unet", "laps_km_unet"):
        port_cfg, jax_cfg = getattr(configs, recipe)(), getattr(configs_jax, recipe)()
        pairs += [(getattr(port_cfg, f.name), getattr(jax_cfg, f.name))
                  for f in dataclasses.fields(jax_cfg)]
    for port_cfg, jax_cfg in pairs:
        assert {f.name for f in dataclasses.fields(port_cfg)} == {
            f.name for f in dataclasses.fields(jax_cfg)}
        for f in dataclasses.fields(port_cfg):
            assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), f.name


def test_synthetic_items_match_jax():
    port = SyntheticNowcastDataset(length=3, img_size=24, seq_len=6, seed=5)
    ref = synthetic_jax.SyntheticNowcastDataset(length=3, img_size=24, seq_len=6, seed=5)
    assert len(port) == len(ref)
    for i in range(3):
        np.testing.assert_array_equal(port[i], ref[i])


def test_engine_refuses_what_the_port_lacks():
    """The train step's options and the zoo are all ported
    (tests/test_torch_optimizers.py, tests/test_torch_train_options.py,
    tests/test_torch_zoo.py): what is left to refuse is what JAX refuses
    too, an unknown model and an unknown loss (ValueError, as
    ``zoo_jax.build`` and ``engine_jax.build_loss``) and rprop under a
    schedule; a baseline such as smaat_unet builds."""
    bad_jax = configs_jax.shanghai_km_unet()
    bad = configs.shanghai_km_unet()
    bad.train.loss = bad_jax.train.loss = "en_rainfall"
    for build_loss in (engine_jax.build_loss, engine.build_loss):
        with pytest.raises(ValueError, match="unknown loss en_rainfall"):
            build_loss(bad_jax if build_loss is engine_jax.build_loss else bad)
    bad = configs.shanghai_km_unet()
    bad.train.optimizer = "rprop"
    with pytest.raises(ValueError, match="rprop"):
        engine.build_optimizer(bad, 10)
    bad, bad_jax = configs.shanghai_km_unet(), configs_jax.shanghai_km_unet()
    bad.model.name = bad_jax.model.name = "unet_9000"
    for build_model in (engine_jax.build_model, engine.build_model):
        with pytest.raises(ValueError, match="unknown model 'unet_9000'"):
            build_model(bad_jax if build_model is engine_jax.build_model else bad)
    good = configs.shanghai_km_unet()
    good.model.name = "smaat_unet"
    assert type(engine.build_model(good)).__name__ == "SmaAt_UNet"


def test_init_state_needs_a_card_unless_cpu_is_asked(monkeypatch):
    cfg = configs.shanghai_km_unet()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = engine.build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_state(cfg, model, engine.build_optimizer(cfg, 10))


# --- the whole step ---------------------------------------------------------

N_STEPS = 2
# Leaves whose exact gradient is 0, so that their computed gradients are
# rounding noise (JAX's float64 gradient holds them below 1e-14 of the
# largest, by scripts/torch_grad_precision.py --jax): each _RowMLP's Dense
# bias and the deformable conv's bias sit right before a BatchNorm (through
# a linear 1x1 conv for the latter), which subtracts the batch mean;
# HSMSSD's A is added to every position inside a softmax over positions.
ZERO_GRADIENT_LEAVES = tuple(f"bridge.{m}.Dense_0.bias" for m in (
    "edge_aggregation", "vertex_update", "edge_update", "edge_reduce")) + (
    "bridge.deform_conv.bias",)
ZERO_GRADIENT_SUFFIX = ".mixer.A"
# Their fp32 noise, against the largest gradient of all: at most 3.3e-6 (JAX)
# and 2.1e-6 (port) by the same script.
ZERO_GRADIENT_SHARE = 1e-5
# Each leaf's fp32 gradient against JAX's, relative to the leaf's largest
# |gradient|. The two agree to 5.5e-4 at worst; that is the reference's own
# fp32 rounding: JAX's fp32 gradient lies up to 4.6e-4 from its float64 one,
# the port's up to 3.7e-4, and the two float64 gradients agree to 2.1e-5
# (scripts/torch_grad_precision.py --jax). The worst leaves are small
# gradients left by cancelling sums (enc1's ViM blocks, 1e-4 of the largest).
GRAD_RTOL = 2e-3
# From the second step on, each leaf's gradient may also lie this share of
# the largest gradient of all from JAX's: the noise the zero-gradient leaves
# are allowed. After one step, the leaves behind the BatchNorm scales that
# start at 0 (each ViM block's FFN: its first conv and BatchNorm) and a
# mixer's D hold gradients of 3e-7 to 2.3e-5 of the largest, left by
# cancelling sums, and there each framework's fp32 gradient lies up to 12 %
# (port) and 6.7 % (JAX) of the leaf from float64, while the two float64
# gradients agree within 1.1e-4 of it: 16 of 644 leaves differ by more than
# GRAD_RTOL, by at most 8.1e-7 of the largest gradient
# (scripts/torch_grad_precision.py --device cpu --jax --seed 0 --jax-steps 1;
# the set and the sizes move with the thread count).
LATER_STEP_SHARE = ZERO_GRADIENT_SHARE


def _adam_update(g: torch.Tensor, mu, nu, count: int) -> torch.Tensor:
    """AdamW's update of an element with gradient g from the moments ``mu``,
    ``nu`` after ``count`` updates, but for the lr and the decay:
    mu_hat / (sqrt(nu_hat) + eps). The first (mu = nu = 0, count 0) is
    g / (|g| + eps)."""
    t = count + 1
    g = g.double()
    mu_hat = (0.9 * mu.double() + 0.1 * g) / (1 - 0.9 ** t)
    nu_hat = (0.999 * nu.double() + 0.001 * g * g) / (1 - 0.999 ** t)
    return mu_hat / (nu_hat.sqrt() + 1e-8)


def _is_zero_gradient_leaf(key: str) -> bool:
    return key in ZERO_GRADIENT_LEAVES or key.endswith(ZERO_GRADIENT_SUFFIX)


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def _small_config(cfg):
    """tests/test_sharding_parity.py's config with B cut to 2 and no
    stochastic depth."""
    cfg.data.img_size = 32
    cfg.data.batch_size = 2
    cfg.data.seq_len = 9
    cfg.data.out_frames = 4
    cfg.model.num_classes = 4
    cfg.model.extra["drop_path"] = 0.0
    cfg.train.compute_dtype = "float32"
    return cfg


def _recording(tx):
    """``tx`` whose state also holds the gradients its last update took."""
    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(
        lambda params: (tx.init(params), jax.tree.map(jnp.zeros_like, params)), update)


def _adam_moments(opt_state):
    """(count, mu, nu) of optax's AdamW state inside ``_recording``'s."""
    (adam,) = [st for st in opt_state[0] if hasattr(st, "mu")]
    return int(adam.count), adam.mu, adam.nu


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's 2 steps (one compile): the initial variables, and for each step
    its metrics, the gradients it applied, and the variables and AdamW
    moments after it. The step is compiled at XLA's default optimisation
    level (3): at the conftest's level 0 this backward comes out wrong by
    more than rounding (the step-2 grad norm moves by 0.4 %), the hazard
    tests/conftest.py names."""
    cfg = _small_config(configs_jax.shanghai_km_unet())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        model = engine_jax.build_model(cfg)
        tx = _recording(engine_jax.build_optimizer(cfg, steps_per_epoch=10))
        # jitted: the eager init of the SH model takes about a minute, its trace
        # and compile less and land in the persistent compilation cache
        state = jax.jit(functools.partial(engine_jax.init_state, cfg, model, tx))(
            jax.random.PRNGKey(0))
        initial = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                       compiler_options={"xla_backend_optimization_level": 3})
        batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
        steps = []
        for i in range(N_STEPS):
            state, m = step(state, jnp.asarray(batch), jax.random.fold_in(jax.random.PRNGKey(3), i))
            steps.append(jax.device_get({
                "metrics": (float(m["loss"]), float(m["grad_norm"])),
                "grads": state.opt_state[1],
                "after": {"params": state.params, "batch_stats": state.batch_stats},
                "adam": _adam_moments(state.opt_state)}))
    assert np.isfinite([s["metrics"] for s in steps]).all()
    return initial, batch, steps


def _assert_step_matches(model, lr, got_grads, got_after, want, before, share=0.0,
                         update=None, zero=None):
    """One step's gradients and the variables after it against JAX's.

    The gradients within GRAD_RTOL of each leaf's largest plus ``share`` of
    the largest gradient of all (the leaves whose exact gradient is 0 only
    below ZERO_GRADIENT_SHARE of the largest gradient, in both); the
    parameters and BatchNorm statistics after it
    within ATOL plus what the two gradients' difference makes of AdamW's
    update from the moments ``before`` ((count, mu, nu) by state_dict name)
    at ``lr``, or of ``update(g)``, the step's update direction for the
    gradient g, where the optimizer is another. ``zero(key)`` names the
    leaves whose exact gradient is 0 (default: this model's,
    ``_is_zero_gradient_leaf``)."""
    stats = want["after"]["batch_stats"]
    want_g = convert.to_state_dict(model, want["grads"], stats)
    largest = max(float(w.abs().max()) for k, w in want_g.items() if k in got_grads)
    for key, g in got_grads.items():
        w = want_g[key]
        if (zero or _is_zero_gradient_leaf)(key):
            assert max(_max(g.abs()), _max(w.abs())) <= ZERO_GRADIENT_SHARE * largest, key
        else:
            err = _max((g - w).abs())
            assert err <= GRAD_RTOL * _max(w.abs()) + share * largest, (key, err, _max(w.abs()))

    count, mu, nu = before
    want_after = convert.to_state_dict(model, want["after"]["params"], stats)
    for key, w in want_after.items():
        if key.endswith("num_batches_tracked"):
            continue
        err = (got_after[key] - w).abs().double()
        if key in got_grads:
            # What the two gradients, held together above, make of the step.
            step_of = update or functools.partial(_adam_update, mu=mu[key], nu=nu[key],
                                                  count=count)
            err = err - lr * (step_of(got_grads[key]) - step_of(want_g[key])).abs()
        assert _max(err) <= ATOL, (key, _max(err))


def test_train_step_matches_jax(jax_steps):
    """Two steps, each held to JAX's: the loss and grad norm within 1e-4
    relative, and the gradients and the variables after it by
    ``_assert_step_matches``. AdamW's update is about lr whatever |g|
    (lr * g / (|g| + eps) on the first step), so two gradients that agree
    within rounding still move an element apart where they differ in sign
    or lie near eps (70 of 1.28 M elements differ by more than 1e-4 so
    after the first step, by scripts/torch_grad_precision.py --jax). Step 1
    starts from JAX's initial variables; step 2 starts from JAX's state
    after step 1 (parameters, statistics, AdamW's moments and count), so
    that it measures the port's step and not that amplification; its leaves
    may also lie LATER_STEP_SHARE of the largest gradient from JAX's."""
    initial, batch, want_steps = jax_steps
    cfg = _small_config(configs.shanghai_km_unet())
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, device="cpu")
    convert.load_flax(model, initial["params"], initial["batch_stats"])
    seen = []  # the gradients each update receives
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.clone() for g in grads]) or update(
        grads, st, params)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    launches = (bilinear.bilinear_gather.launches, bilinear.bilinear_gather_backward.launches)
    zeros = {k: torch.zeros_like(p) for k, p in state.params.items()}
    before = (0, zeros, zeros)
    for i, want in enumerate(want_steps):
        if i > 0:  # start from JAX's state after the previous step
            prev = want_steps[i - 1]
            stats = prev["after"]["batch_stats"]
            convert.load_flax(model, prev["after"]["params"], stats)
            count, mu, nu = prev["adam"]
            mu, nu = (convert.to_state_dict(model, m, stats) for m in (mu, nu))
            state = engine.TrainState(i, state.params, state.batch_stats, OptState(
                count, [mu[k].clone() for k in state.params], [nu[k].clone() for k in state.params]))
            before = (count, mu, nu)
        state, m = step(state, batch, None)
        metrics = (float(m["loss"]), float(m["grad_norm"]))
        np.testing.assert_allclose(metrics, want["metrics"], rtol=1e-4, atol=0,
                                   err_msg=f"step {i + 1}")
        got_after = {k: v.clone() for k, v in model.state_dict().items()}
        _assert_step_matches(model, tx.lr(before[0]), dict(zip(state.params, seen[i])),
                             got_after, want, before, share=LATER_STEP_SHARE if i else 0.0)
    assert (bilinear.bilinear_gather.launches,
            bilinear.bilinear_gather_backward.launches) == launches  # CPU: plain versions
    assert state.step == N_STEPS and state.opt_state.count == N_STEPS


def test_sharded_rows_step_matches_jax(jax_steps, tmp_path):
    """The first step with the image rows sharded over two gloo ranks (dp1
    x sp2, each rank on 16 of the 32 rows: ``parallel/halo.py``) from JAX's
    initial variables, held to JAX's step on the whole batch by
    ``test_train_step_matches_jax``'s rules: each rank's loss and grad norm
    within 1e-4 relative, its gradients leaf by leaf and its variables after
    the step by ``_assert_step_matches``."""
    initial, batch, want_steps = jax_steps
    cfg = _small_config(configs.shanghai_km_unet())
    model = engine.build_model(cfg)
    convert.load_flax(model, initial["params"], initial["batch_stats"])
    torch.save(model.state_dict(), tmp_path / "initial.pt")
    jobs = [(torch_rows.jax_start_step_job, (str(tmp_path / "initial.pt"),
                                             torch.from_numpy(batch)))]
    ranks = torch_ranks.spawn(torch_ranks.run_jobs, 2, tmp_path, jobs, timeout=300)
    zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    lr = engine.build_optimizer(cfg, steps_per_epoch=10).lr(0)
    for (got,) in ranks:
        np.testing.assert_allclose(got["metrics"], want_steps[0]["metrics"], rtol=1e-4, atol=0)
        _assert_step_matches(model, lr, got["grads"], got["after"], want_steps[0],
                             (0, zeros, zeros))
