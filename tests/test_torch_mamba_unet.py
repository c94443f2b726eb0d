"""Mamba-UNet and its training recipe against the JAX package, on the CPU.

With converted, perturbed weights (tests/torch_parity.py), fp32, within
1e-4 abs (the per-layer bound of BASELINE.json): ``MambaBlock`` (output and
the gradients to its input and every parameter) and its causality,
``DMFMLayer``, the three bridges, the 2x2 "SAME" transposed conv and the
whole ``Mamba_UNet`` at 32^2, B=2, 5 -> 4 frames; the converter's strictness
on the new leaves; ``rainfall_loss`` and ``rain_loss``, SGD against optax
with and without decay, CosineAnnealingLR against ``make_schedule``; the
zoo and ``build_zoo_model``; and one ("mamba_unet", "pic") train step
against ``kmunet_tpu.train.engine``, held as tests/test_torch_train.py holds
the SH step. Each JAX function is jitted, so that it compiles once; the step
compiles once per file, in a module fixture. Every input is drawn from this
file's own seeded generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.models.mamba_unet as mamba_unet_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.losses.losses import rain_loss as rain_loss_jax
from kmunet_tpu.losses.losses import rainfall_loss as rainfall_loss_jax
from kmunet_tpu.nn.mamba import MambaBlock as MambaBlockJax
from kmunet_tpu.train import optimizers as optimizers_jax
from kmunet_tpu.train import recipes as recipes_jax
from kmunet_tpu_torch import configs, convert, serve
from kmunet_tpu_torch.kernels import scan
from kmunet_tpu_torch.losses import rain_loss, rainfall_loss
from kmunet_tpu_torch.models import mamba_unet, zoo
from kmunet_tpu_torch.nn.mamba import MambaBlock
from kmunet_tpu_torch.parallel import make_mesh
from kmunet_tpu_torch.train import engine, recipes
from kmunet_tpu_torch.train.optimizers import SGD, make_optimizer
from kmunet_tpu_torch.train.schedule import make_schedule
from tests.test_torch_train import _assert_step_matches, _recording
from tests.torch_parity import init_perturbed, nchw, nhwc, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4
C_LIST = (8, 16, 24, 32, 48, 64)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _jax_vjp(module, variables):
    """jit of (output, parameter gradients, input gradients) of
    ``module.apply`` for an upstream gradient."""
    def run(params, inputs, g):
        out, vjp = jax.vjp(lambda p, a: module.apply({"params": p}, *a), params, inputs)
        d_params, d_inputs = vjp(g)
        return out, d_params, d_inputs

    return jax.jit(run)


def _assert_param_grads(tm, d_params):
    want = convert.to_state_dict(tm, d_params)
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), rtol=0, atol=ATOL,
                                   err_msg=key)


def test_mamba_block_matches_jax():
    """(B, L, D) tokens at L=64, d_model 24 (dt_rank 2), N=16: the output
    and the gradients to the tokens and to every parameter."""
    x = _normal((2, 64, 24), 0)
    jm = MambaBlockJax(d_model=24)
    variables = init_perturbed(jm, jnp.asarray(x), seed=1)
    g = _normal((2, 64, 24), 2)
    out, d_params, (d_x,) = _jax_vjp(jm, variables)(variables["params"], (jnp.asarray(x),),
                                                     jnp.asarray(g))
    tm = port(MambaBlock(24), variables)
    assert tm.dt_rank == 2 and tuple(tm.conv1d_weight.shape) == (48, 1, 4)
    x_t = torch.from_numpy(x).requires_grad_()
    got = tm(x_t)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(d_x), rtol=0, atol=ATOL)
    _assert_param_grads(tm, d_params)


def test_mamba_block_is_causal():
    """Changing the tokens from 20 on changes no output before 20."""
    tm = MambaBlock(16)
    mamba_unet.init_weights_(tm, torch.Generator().manual_seed(3))
    x = torch.from_numpy(_normal((1, 40, 16), 4))
    x2 = x.clone()
    x2[:, 20:] += 1.0
    with torch.no_grad():
        y1, y2 = tm(x), tm(x2)
    torch.testing.assert_close(y1[:, :20], y2[:, :20], rtol=0, atol=1e-7)
    assert float((y1[:, 20:] - y2[:, 20:]).abs().max()) > 1e-3


def test_dmfm_layer_matches_jax():
    """DMFM on an 8x8 map of 16 channels (group 8: 2 channels a group) to 24:
    one norm used three times and one MambaBlock on both views, so their
    gradients add up over the uses."""
    x = _normal((2, 8, 8, 16), 5)
    jm = mamba_unet_jax.DMFMLayer(output_dim=24)
    variables = init_perturbed(jm, jnp.asarray(x), seed=6)
    g = _normal((2, 8, 8, 24), 7)
    out, d_params, (d_x,) = _jax_vjp(jm, variables)(variables["params"], (jnp.asarray(x),),
                                                     jnp.asarray(g))
    tm = port(mamba_unet.DMFMLayer(16, 24), variables)
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    _assert_param_grads(tm, d_params)


def _skips(seed):
    """The five skips of Mamba-UNet at 32^2 input: (2, 16/2^i, 16/2^i, c_i)."""
    return [_normal((2, 16 >> i, 16 >> i, c), seed + i) for i, c in enumerate(C_LIST[:5])]


@pytest.mark.parametrize("name", ["satt", "catt", "scab"])
def test_bridges_match_jax(name):
    """SpatialAttBridge (the shared dilated 7x7 conv), ChannelAttBridge (the
    conv1d over the 128 pooled channels, one linear per scale) and the whole
    MultiScaleSTAMBridge over the five skips: outputs and the gradients to
    every skip and every parameter."""
    ts = _skips(8)
    jm, tm = {"satt": (mamba_unet_jax.SpatialAttBridge(), mamba_unet.SpatialAttBridge()),
              "catt": (mamba_unet_jax.ChannelAttBridge(C_LIST[:5]),
                       mamba_unet.ChannelAttBridge(C_LIST[:5])),
              "scab": (mamba_unet_jax.MultiScaleSTAMBridge(C_LIST[:5]),
                       mamba_unet.MultiScaleSTAMBridge(C_LIST[:5]))}[name]
    jts = [jnp.asarray(t) for t in ts]
    variables = init_perturbed(jm, jts, seed=13)
    outs = jax.eval_shape(lambda p, a: jm.apply({"params": p}, a), variables["params"], jts)
    gs = [_normal(o.shape, 14 + i) for i, o in enumerate(outs)]
    out, d_params, (d_ts,) = _jax_vjp(jm, variables)(variables["params"], (jts,),
                                                     [jnp.asarray(a) for a in gs])
    port(tm, variables)
    ts_t = [nchw(t).requires_grad_() for t in ts]
    got = tm(ts_t)
    torch.autograd.backward(got, [nchw(a) for a in gs])
    for a, b in zip(got, out):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=0, atol=ATOL)
    for a, b in zip(ts_t, d_ts):
        np.testing.assert_allclose(nhwc(a.grad), np.asarray(b), rtol=0, atol=ATOL)
    _assert_param_grads(tm, d_params)


def test_conv_t_same_2x2_matches_flax():
    """flax's ``ConvTranspose((2, 2), strides=(2, 2), padding='SAME',
    transpose_kernel=True)`` is PyTorch's padding 0 with the kernel as the
    converter lays it out, unflipped: each pixel to its own 2x2 block."""
    x = _normal((2, 5, 6, 3), 19)
    jm = flax_nn.ConvTranspose(3, (2, 2), strides=(2, 2), transpose_kernel=True)
    variables = init_perturbed(jm, jnp.asarray(x), seed=20)
    g = _normal((2, 10, 12, 3), 21)
    out, d_params, (d_x,) = _jax_vjp(jm, variables)(variables["params"], (jnp.asarray(x),),
                                                     jnp.asarray(g))
    tm = port(mamba_unet._up(3), variables)
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    _assert_param_grads(tm, d_params)


@pytest.fixture(scope="module")
def perturbed_params():
    """Perturbed flax parameters of Mamba_UNet(predicted_frames=4) at 32^2
    (``init_perturbed``: the variables' shapes are traced once, nothing is
    compiled), shared by the whole-model, converter and step tests."""
    model = mamba_unet_jax.Mamba_UNet(predicted_frames=4)
    return init_perturbed(model, jnp.zeros((1, 32, 32, 5)), seed=23)["params"]


def test_whole_model_matches_jax(perturbed_params):
    """Mamba_UNet at 32^2, B=2, 5 -> 4 frames, fp32, converted perturbed
    weights: 20 scans, on the plain version here."""
    x = np.random.default_rng(22).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    jm = mamba_unet_jax.Mamba_UNet(predicted_frames=4)
    variables = {"params": perturbed_params}
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = port(mamba_unet.Mamba_UNet(predicted_frames=4), variables)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append(inp[0].shape[1]))
             for m in tm.modules() if isinstance(m, MambaBlock)]
    before = scan.selective_scan.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert scan.selective_scan.launches == before  # CPU: the plain version
    assert len(seen) == 20 and sorted(set(seen)) == [1, 4, 16, 1024]
    assert got.shape == want.shape == (2, 32, 32, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_converter_is_strict_on_the_new_leaves(perturbed_params):
    """Every new leaf converts (Mamba's conv1d and dt_proj kernels and the
    bridge's conv1d in PyTorch layout); a missing A_log, an extra 0-d
    scale, and the bridge's leaves on a model built without it all fail."""
    params = perturbed_params
    model = mamba_unet.Mamba_UNet(predicted_frames=4)
    state = convert.to_state_dict(model, params)
    mamba = params["refine1"]["mamba"]
    np.testing.assert_array_equal(state["refine1.mamba.conv1d_weight"].numpy(),
                                  mamba["conv1d_kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["refine1.mamba.dt_proj_weight"].numpy(),
                                  mamba["dt_proj_kernel"].T)
    np.testing.assert_array_equal(state["scab.catt.get_all_att_weight"].numpy(),
                                  params["scab"]["catt"]["get_all_att_kernel"].transpose(2, 1, 0))
    assert state["beta"].shape == () and state["scab.alpha2"].shape == ()
    missing = {**params, "encoder4": {**params["encoder4"], "mamba": {
        k: v for k, v in params["encoder4"]["mamba"].items() if k != "A_log"}}}
    with pytest.raises(KeyError, match="encoder4.mamba.A_log"):
        convert.to_state_dict(model, missing)
    extra = {**params, "scab": {**params["scab"], "alpha4": params["scab"]["alpha1"]}}
    with pytest.raises(KeyError, match="scab/alpha4"):
        convert.to_state_dict(model, extra)
    with pytest.raises(KeyError, match="scab/catt/get_all_att_kernel"):
        convert.to_state_dict(mamba_unet.Mamba_UNet(predicted_frames=4, bridge=False), params)


def test_rainfall_and_rain_losses_match_jax():
    """Targets on both sides of 0.7 and predictions on both sides of the
    target: the value and the gradient to the prediction."""
    rng = np.random.default_rng(25)
    p = rng.uniform(0, 1, (2, 4, 12, 10)).astype(np.float32)
    t = rng.uniform(0, 1, (2, 4, 12, 10)).astype(np.float32)
    assert (t >= 0.7).any() and (t < 0.7).any() and (p >= t).any() and (p < t).any()
    for port_fn, jax_fn in ((rainfall_loss, rainfall_loss_jax), (rain_loss, rain_loss_jax)):
        want, want_grad = jax.value_and_grad(lambda a: jax_fn(a, jnp.asarray(t)))(jnp.asarray(p))
        p_t = torch.from_numpy(p).requires_grad_()
        got = port_fn(p_t, torch.from_numpy(t))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                                   atol=1e-10)


def test_cosine_annealing_schedule_matches_jax():
    port_s = make_schedule("CosineAnnealingLR", 1e-3, 3, t_max=5, eta_min=1e-5)
    ref = optimizers_jax.make_schedule("CosineAnnealingLR", 1e-3, 3, t_max=5, eta_min=1e-5)
    steps = range(40)
    np.testing.assert_allclose([port_s(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6)
    assert port_s(2) == 1e-3 and port_s(15) == pytest.approx(1e-5)  # per epoch of 3 steps


@pytest.mark.parametrize("momentum,weight_decay", [(0.9, 0.0), (0.9, 1e-2), (0.0, 1e-2)])
def test_sgd_steps_match_optax(momentum, weight_decay):
    """Three steps of ``make_optimizer("sgd")`` on a small pytree under the
    port's CosineAnnealingLR of one step per epoch, against the JAX
    factory's (``optax.sgd`` with its trace from 0; a nonzero decay chained
    before it, coupled into the gradient; momentum 0 plain SGD) under the
    same learning rates. (JAX computes the schedule in fp32, the port in
    float64: the two lie up to an fp32 ulp apart,
    ``test_cosine_annealing_schedule_matches_jax``.)"""
    rng = np.random.default_rng(26)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr = make_schedule("CosineAnnealingLR", 1e-1, 1, t_max=4, eta_min=1e-4)
    tx = optimizers_jax.make_optimizer("sgd", lambda count: lr(int(count)),
                                       weight_decay=weight_decay, momentum=momentum)
    p_jax = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p_jax)
    port_tx = make_optimizer("sgd", lr, weight_decay=weight_decay, momentum=momentum)
    assert isinstance(port_tx, SGD)
    p_port = [torch.from_numpy(params[k].copy()) for k in shapes]
    state = port_tx.init(p_port)
    assert len(state.mu) == (2 if momentum else 0)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        state = port_tx.update([torch.from_numpy(g[k]) for k in shapes], state, p_port)
    assert state.count == 3
    for k, p in zip(shapes, p_port):
        np.testing.assert_allclose(p.numpy(), np.asarray(p_jax[k]), rtol=0, atol=1e-7)


def test_recipe_builds_the_pieces():
    """("mamba_unet", "pic"): SGD lr 1e-3, momentum 0.9, coupled decay 1e-4,
    rainfall loss, CosineAnnealingLR T_max 50 down to 1e-5, per epoch; the
    "nc" recipe's Adam with the same schedule builds too."""
    cfg = recipes.apply_recipe(configs.shanghai_km_unet(), "mamba_unet", "pic")
    assert (cfg.train.optimizer, cfg.train.momentum, cfg.train.weight_decay) == ("sgd", 0.9, 1e-4)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    assert isinstance(tx, SGD) and (tx.momentum, tx.l2) == (0.9, 1e-4)
    assert tx.lr(9) == 1e-3 and tx.lr(500) == pytest.approx(1e-5)
    assert engine.build_loss(cfg) is rainfall_loss
    rain = configs.shanghai_km_unet()
    rain.train.loss = "rain"
    assert engine.build_loss(rain) is rain_loss
    nc = recipes.apply_recipe(configs.shanghai_km_unet(), "mamba_unet", "nc")
    assert type(engine.build_optimizer(nc, 10)).__name__ == "Adam"


def test_zoo_and_entry_point(monkeypatch):
    """The zoo builds Mamba-UNet with its ``c_list`` and ``bridge`` extras and
    passes ``seq_mesh`` through to every MambaBlock (the sequence-parallel
    scan, tests/test_torch_scan_sharded.py); ``build_zoo_model("mamba_unet")`` is seeded, in
    eval mode, with MambaBlock's inits, maps (B, 32, 32, 5) to (B, 32, 32,
    20), and is on the card unless the CPU is asked for."""
    cfg = configs.ModelConfig(name="mamba_unet", num_classes=3, extra={"bridge": False})
    model = zoo.build(cfg)
    assert isinstance(model, mamba_unet.Mamba_UNet) and not hasattr(model, "scab")
    assert tuple(model.S.weight.shape) == (3, 3, 3, 3)
    mesh = make_mesh()
    sharded = zoo.build(configs.ModelConfig(name="mamba_unet", extra={"seq_mesh": mesh}))
    blocks = [m for m in sharded.modules() if isinstance(m, MambaBlock)]
    assert len(blocks) == 10 and all(b.seq_mesh is mesh and b.seq_axis == "spatial"
                                     for b in blocks)
    assert zoo.SEQUENCE_MODELS == {"convlstm", "trajgru"}

    model = serve.build_zoo_model("mamba_unet", device="cpu", seed=3)
    again = serve.build_zoo_model("mamba_unet", device="cpu", seed=3)
    assert not model.training
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    block = model.refine3.mamba
    np.testing.assert_allclose(block.A_log[5].detach().numpy(), np.log(np.arange(1, 17)),
                               rtol=1e-6)
    assert bool((block.D == 1).all())
    assert float(block.dt_proj_weight.detach().abs().max()) <= 2**-0.5
    dt = torch.nn.functional.softplus(block.dt_proj_bias.detach())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    frames = np.random.default_rng(27).uniform(size=(1, 32, 32, 5)).astype(np.float32)
    out = serve.predict(model, frames)
    assert out.shape == (1, 32, 32, 20) and bool(torch.isfinite(out).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_zoo_model("mamba_unet")
    cfg = recipes.apply_recipe(configs.shanghai_km_unet(), "mamba_unet", "pic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_state(cfg, engine.build_model(cfg), engine.build_optimizer(cfg, 10))


# --- one recipe step ----------------------------------------------------------


def _small_recipe_config(cfg):
    """The ("mamba_unet", "pic") recipe at 32^2, B=2, 5 -> 4 frames, fp32."""
    cfg.data.img_size = 32
    cfg.data.batch_size = 2
    cfg.data.seq_len = 9
    cfg.data.out_frames = 4
    cfg.model.num_classes = 4
    cfg.train.compute_dtype = "float32"
    return cfg


def _recipe_batch():
    """Frames in [0, 1]: the targets fall on both sides of the loss's 0.7."""
    return np.random.default_rng(28).random((2, 9, 32, 32), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_mamba_step(perturbed_params):
    """JAX's step of the recipe (one compile, at XLA's default optimisation
    level 3, as tests/test_torch_train.py compiles the SH step): the initial
    parameters and the step's metrics, gradients and parameters after it.
    The step starts from the perturbed parameters (no init to compile)."""
    cfg = _small_recipe_config(recipes_jax.apply_recipe(configs_jax.shanghai_km_unet(),
                                                        "mamba_unet", "pic"))
    model = engine_jax.build_model(cfg)
    tx = _recording(engine_jax.build_optimizer(cfg, steps_per_epoch=10))
    params = jax.tree.map(jnp.asarray, perturbed_params)
    state = engine_jax.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats={}, opt_state=tx.init(params))
    initial = jax.device_get(params)
    step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                   compiler_options={"xla_backend_optimization_level": 3})
    state, m = step(state, jnp.asarray(_recipe_batch()), jax.random.PRNGKey(3))
    want = jax.device_get({"metrics": (float(m["loss"]), float(m["grad_norm"])),
                           "grads": state.opt_state[1],
                           "after": {"params": state.params, "batch_stats": {}}})
    assert np.isfinite(want["metrics"]).all()
    return initial, want


def test_mamba_recipe_step_matches_jax(jax_mamba_step):
    """One step of the ("mamba_unet", "pic") recipe (SGD lr 1e-3 with
    momentum 0.9 and coupled decay 1e-4, rainfall loss, CosineAnnealingLR)
    from the same perturbed parameters: the loss and grad norm within 1e-4
    relative; the gradients leaf by leaf within GRAD_RTOL of each leaf's
    largest; the parameters after it within 1e-4 plus lr times the two
    gradients' difference (SGD's first update from a zero trace is
    lr * (g + 1e-4 * p); tests/test_torch_train.py's ``_assert_step_matches``)."""
    initial, want = jax_mamba_step
    cfg = _small_recipe_config(recipes.apply_recipe(configs.shanghai_km_unet(),
                                                    "mamba_unet", "pic"))
    model = engine.build_model(cfg)
    assert isinstance(model, mamba_unet.Mamba_UNet)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, device="cpu")
    assert state.batch_stats == {}
    convert.load_flax(model, initial)
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.clone() for g in grads]) or update(
        grads, st, params)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    launches = (scan.selective_scan.launches, scan.selective_scan_backward.launches)
    state, m = step(state, _recipe_batch(), None)
    np.testing.assert_allclose((float(m["loss"]), float(m["grad_norm"])), want["metrics"],
                               rtol=1e-4, atol=0)
    _assert_step_matches(model, tx.lr(0), dict(zip(state.params, seen[0])),
                         {k: v.clone() for k, v in model.state_dict().items()}, want,
                         (0, {}, {}), update=lambda g: g)
    assert (scan.selective_scan.launches,
            scan.selective_scan_backward.launches) == launches  # CPU: plain
    assert state.step == 1 and state.opt_state.count == 1
