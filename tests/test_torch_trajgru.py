"""The encoder-forecaster RNNs (ConvLSTM, TrajGRU) of the port and their
training recipe against the JAX package, on the CPU.

With converted, perturbed weights (tests/torch_parity.py), fp32, within
1e-4 abs (the per-layer bound of BASELINE.json): ``conv_t`` against flax's
``ConvTranspose(transpose_kernel=True)``; ``ConvLSTMCell`` and
``TrajGRUCell`` (``use_input`` True and False), outputs and the gradients to
the state, the input and every parameter; the whole ``ConvLSTM_EF`` and
``TrajGRU_EF`` at 64^2, B=2, 5 -> 4 frames. TrajGRU's bf16 warp coordinates
bit for bit against JAX's; the converter's strictness on the cells' keys;
``weighted_mse_mae`` with targets across its thresholds; Adam and
MultiStepLR against optax and ``make_schedule``; the recipes table; one
``("trajgru", "pic")`` train step against ``kmunet_tpu.train.engine``, held
as tests/test_torch_train.py holds the SH step (its checks, imported); and
the entry points on the card by default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.models.ef as ef_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.losses.losses import weighted_mse_mae as weighted_mse_mae_jax
from kmunet_tpu.train import optimizers as optimizers_jax
from kmunet_tpu.train import recipes as recipes_jax
from kmunet_tpu_torch import configs, convert, serve
from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.losses import weighted_mse_mae
from kmunet_tpu_torch.models import ef, zoo
from kmunet_tpu_torch.train import engine, recipes
from kmunet_tpu_torch.train.optimizers import make_optimizer
from kmunet_tpu_torch.train.schedule import make_schedule
from tests.test_torch_train import _assert_step_matches, _recording
from tests.torch_parity import init_perturbed, nchw, nhwc, port

ATOL = 1e-4


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (6, 4, 1), (3, 1, 1)])
def test_conv_t_matches_flax(k, s, p):
    """The converter's conv rule takes flax's (kh, kw, out, in) kernel to
    ConvTranspose2d's (in, out, kh, kw) with no spatial flip; output size
    (in-1)*s - 2p + k; the input gradient too."""
    x = _normal((2, 5, 6, 7), 0)
    jm = ef_jax.conv_t(3, k, s, p)
    variables = init_perturbed(jm, jnp.asarray(x), seed=k)
    out, vjp = jax.vjp(lambda a: jm.apply(variables, a), jnp.asarray(x))
    assert out.shape == (2, (5 - 1) * s - 2 * p + k, (6 - 1) * s - 2 * p + k, 3)
    g = _normal(out.shape, 1)
    (want_dx,) = vjp(jnp.asarray(g))
    tm = port(ef.conv_t(7, 3, k, s, p), variables)
    x_t = nchw(x).requires_grad_()
    got = tm(x_t)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(want_dx), rtol=0, atol=ATOL)


def _cell_case(kind, use_input):
    """(flax cell, port cell, carry arrays NHWC, input NHWC): 8x8 state of 6
    channels, 5 input channels, L=4 flow fields for TrajGRU."""
    h = _normal((2, 8, 8, 6), 2)
    x = _normal((2, 8, 8, 5 if use_input else 0), 3)
    if kind == "convlstm":
        return (ef_jax.ConvLSTMCell(6), ef.ConvLSTMCell(5, 6), (h, _normal(h.shape, 4)), x)
    return (ef_jax.TrajGRUCell(6, L=4, use_input=use_input),
            ef.TrajGRUCell(5, 6, L=4, use_input=use_input), h, x)


@pytest.mark.parametrize("kind,use_input", [("convlstm", True), ("trajgru", True),
                                            ("trajgru", False)])
def test_cell_matches_jax(kind, use_input):
    """One step of the cell: the new state and the gradients to the carry,
    the input and every parameter. TrajGRU's flows reach 3 px (std 0.6) with
    these weights, so the warp samples between pixels and off the image."""
    jm, tm, carry, x = _cell_case(kind, use_input)
    jcarry = jax.tree.map(jnp.asarray, carry)
    variables = init_perturbed(jm, jcarry, jnp.asarray(x), seed=5)

    def fwd(p, c, a):
        return jm.apply({"params": p}, c, a)[0]

    out, vjp = jax.vjp(fwd, variables["params"], jcarry, jnp.asarray(x))
    g = jax.tree.map(lambda o: _normal(o.shape, 6), out)
    d_params, d_carry, d_x = vjp(jax.tree.map(jnp.asarray, g))
    port(tm, variables).train()
    carry_t = jax.tree.map(lambda a: nchw(a).requires_grad_(), carry)
    x_t = nchw(x).requires_grad_() if use_input else None
    got = tm(carry_t, x_t)
    torch.autograd.backward(jax.tree.leaves(got), [nchw(a) for a in jax.tree.leaves(g)])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(out)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=0, atol=ATOL)
    for a, b in zip(jax.tree.leaves(carry_t), jax.tree.leaves(d_carry)):
        np.testing.assert_allclose(nhwc(a.grad), np.asarray(b), rtol=0, atol=ATOL)
    if use_input:
        np.testing.assert_allclose(nhwc(x_t.grad), np.asarray(d_x), rtol=0, atol=ATOL)
    want = convert.to_state_dict(tm, d_params)
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), rtol=0, atol=ATOL,
                                   err_msg=key)
    if kind == "trajgru":
        assert (hasattr(tm, "i2h") and hasattr(tm, "i2f_conv1")) == use_input


@pytest.mark.parametrize("name", ["convlstm", "trajgru"])
def test_whole_model_matches_jax(name):
    """The whole model at 64^2, B=2, 5 -> 4 frames, fp32, converted
    perturbed weights; 15 + 12 multiview gathers in TrajGRU's forward, all
    on the plain version here."""
    x = np.random.default_rng(7).uniform(size=(2, 5, 64, 64)).astype(np.float32)
    jm = (ef_jax.ConvLSTM_EF if name == "convlstm" else ef_jax.TrajGRU_EF)(out_frames=4)
    variables = init_perturbed(jm, jnp.asarray(x), seed=8)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = port((ef.ConvLSTM_EF if name == "convlstm" else ef.TrajGRU_EF)(out_frames=4), variables)
    assert tuple(tm.state_dict()["enc_rnn1.ret.weight" if name == "trajgru" else
                                 "enc_rnn1.conv.weight"].shape) == (
        (192, 832, 1, 1) if name == "trajgru" else (256, 72, 3, 3))
    before = bilinear.bilinear_gather_multiview.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert bilinear.bilinear_gather_multiview.launches == before  # CPU: plain version
    assert got.shape == want.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_trajgru_bf16_coordinates_match_jax(monkeypatch):
    """bf16 at 32x32: from the same bf16 flows, the coordinates the port's
    cell hands to the gather equal JAX's bit for bit. JAX builds them in the
    state's dtype, ``arange - flow``, so at 16-31 px they are 0.125 px apart;
    built in fp32 they land elsewhere, which the test checks too."""
    jm = ef_jax.TrajGRUCell(16, L=5)
    h = _normal((2, 32, 32, 16), 9)
    x = _normal((2, 32, 32, 4), 10)
    variables = init_perturbed(jm, jnp.asarray(h), jnp.asarray(x), seed=11)
    seen_jax = {}
    gather_jax = ef_jax.bilinear_gather_multiview

    def record_jax(img, vx, vy, padding_mode):
        seen_jax.update(x=np.asarray(vx.astype(jnp.float32)), y=np.asarray(vy.astype(jnp.float32)))
        return gather_jax(img, vx, vy, padding_mode=padding_mode)

    monkeypatch.setattr(ef_jax, "bilinear_gather_multiview", record_jax)
    vb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    _, inter = jm.apply(vb, jnp.asarray(h, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
                        capture_intermediates=True, mutable=["intermediates"])
    flows = inter["intermediates"]["flows_conv"]["__call__"][0]
    assert flows.dtype == jnp.bfloat16 and float(jnp.abs(flows).max()) > 1.0
    flows_t = nchw(np.asarray(flows.astype(jnp.float32))).bfloat16()

    seen = {}
    gather = ef.bilinear_gather_multiview

    def record(img, vx, vy, padding_mode):
        seen.update(x=vx.numpy(), y=vy.numpy())
        return gather(img, vx, vy, padding_mode=padding_mode)

    monkeypatch.setattr(ef, "bilinear_gather_multiview", record)
    tm = convert.load_flax(ef.TrajGRUCell(4, 16, L=5), variables["params"]).to(torch.bfloat16)
    tm.flows_conv.register_forward_hook(lambda mod, inp, out: flows_t)
    with torch.no_grad():
        tm(nchw(h).bfloat16(), nchw(x).bfloat16())
    assert seen["x"].dtype == np.float32
    np.testing.assert_array_equal(seen["x"], seen_jax["x"])
    np.testing.assert_array_equal(seen["y"], seen_jax["y"])
    x32, _ = ef.warp_coordinates(flows_t.float(), 5, torch.float32)
    assert not np.array_equal(x32.numpy(), seen_jax["x"])  # fp32-built coordinates differ


def test_converter_is_strict_on_the_cells():
    """``fore_rnn3`` (``use_input=False``) has no ``i2f_conv1``/``i2h``: a
    flax tree that carries them, or one that lacks another cell's, fails."""
    x = jnp.zeros((1, 5, 32, 32))
    variables = init_perturbed(ef_jax.TrajGRU_EF(out_frames=2), x, seed=12)
    params = variables["params"]
    assert "i2h" not in params["fore_rnn3"] and "i2h" in params["fore_rnn2"]
    model = ef.TrajGRU_EF(out_frames=2)
    convert.load_flax(model, params)  # the tree as it is loads
    extra = {**params, "fore_rnn3": {**params["fore_rnn3"], "i2h": params["fore_rnn2"]["i2h"]}}
    with pytest.raises(KeyError, match="fore_rnn3/i2h"):
        convert.to_state_dict(model, extra)
    missing = {**params, "fore_rnn2": {k: v for k, v in params["fore_rnn2"].items()
                                       if k != "i2f_conv1"}}
    with pytest.raises(KeyError, match="fore_rnn2.i2f_conv1"):
        convert.to_state_dict(model, missing)
    lstm = init_perturbed(ef_jax.ConvLSTM_EF(out_frames=2), x, seed=13)["params"]
    state = convert.to_state_dict(ef.ConvLSTM_EF(out_frames=2), lstm)
    np.testing.assert_array_equal(state["enc_rnn2.Wcf"].numpy(), lstm["enc_rnn2"]["Wcf"])


@pytest.mark.parametrize("lam", [None, 0.1])
def test_weighted_mse_mae_matches_jax(lam):
    """Targets across the thresholds 20/30/35/40 (every band weighted), the
    value and the gradient to the prediction."""
    rng = np.random.default_rng(14)
    p = rng.uniform(0, 50, (2, 4, 1, 12, 10)).astype(np.float32)
    t = rng.uniform(0, 50, (2, 4, 1, 12, 10)).astype(np.float32)
    thr = (20, 30, 35, 40)
    for lo, hi in ((0, 20), (20, 30), (30, 35), (35, 40), (40, 50)):
        assert ((t >= lo) & (t < hi)).any()
    want, want_grad = jax.value_and_grad(lambda a: weighted_mse_mae_jax(
        a, jnp.asarray(t), lam=lam, thresholds=thr))(jnp.asarray(p))
    p_t = torch.from_numpy(p).requires_grad_()
    got = weighted_mse_mae(p_t, torch.from_numpy(t), lam=lam, thresholds=thr)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-9)


def test_multistep_schedule_matches_jax():
    port_s = make_schedule("MultiStepLR", 1e-3, 2, milestones=(3, 1, 4), gamma=0.5)
    ref = optimizers_jax.make_schedule("MultiStepLR", 1e-3, 2, milestones=(3, 1, 4), gamma=0.5)
    steps = range(14)
    np.testing.assert_allclose([port_s(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6)
    assert port_s(1) == 1e-3 and port_s(2) == 5e-4  # per epoch of 2 steps
    with pytest.raises(ValueError, match="unsupported scheduler"):
        make_schedule("OneCycleLR", 1e-3, 2)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_steps_match_optax(weight_decay):
    """Three steps of ``make_optimizer("adam")`` on a small pytree under a
    MultiStepLR that decays after the first, against the JAX factory's
    (``optax.adam``; a nonzero decay chained before it, coupled as torch's
    Adam)."""
    rng = np.random.default_rng(15)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optimizers_jax.make_optimizer("adam", optimizers_jax.make_schedule(
        "MultiStepLR", 1e-3, 1, milestones=(1,), gamma=0.1), weight_decay=weight_decay)
    p_jax = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p_jax)
    port_tx = make_optimizer("adam", make_schedule("MultiStepLR", 1e-3, 1, milestones=(1,),
                                                   gamma=0.1), weight_decay=weight_decay)
    p_port = [torch.from_numpy(params[k].copy()) for k in shapes]
    state = port_tx.init(p_port)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        state = port_tx.update([torch.from_numpy(g[k]) for k in shapes], state, p_port)
    assert state.count == 3
    for k, p in zip(shapes, p_port):
        np.testing.assert_allclose(p.numpy(), np.asarray(p_jax[k]), rtol=0, atol=1e-7)


def test_recipes_match_jax():
    """The table's data and ``apply_recipe``'s effect on every field of the
    port's TrainConfig, for every (model, recipe)."""
    assert set(recipes.RECIPES) == set(recipes_jax.RECIPES)
    for key, r in recipes.RECIPES.items():
        assert dataclasses.asdict(r) == dataclasses.asdict(recipes_jax.RECIPES[key]), key
        port_cfg = recipes.apply_recipe(configs.shanghai_km_unet(), *key)
        jax_cfg = recipes_jax.apply_recipe(configs_jax.shanghai_km_unet(), *key)
        assert port_cfg.model.name == jax_cfg.model.name == key[0]
        for f in dataclasses.fields(port_cfg.train):
            assert getattr(port_cfg.train, f.name) == getattr(jax_cfg.train, f.name), (key, f.name)
    with pytest.raises(KeyError, match="no reference recipe"):
        recipes.apply_recipe(configs.shanghai_km_unet(), "km_unet_v3", "pic")


def test_zoo_builds_the_port_models_and_refuses_the_others():
    cfg = configs.ModelConfig(name="trajgru", num_classes=3)
    assert isinstance(zoo.build(cfg), ef.TrajGRU_EF) and zoo.build(cfg).out_frames == 3
    assert isinstance(zoo.build(configs.ModelConfig(name="convlstm")), ef.ConvLSTM_EF)
    assert zoo.SEQUENCE_MODELS == {"convlstm", "trajgru"}
    for name in ("smaat_unet", "lptqpn", "swin_unet"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
            zoo.build(configs.ModelConfig(name=name))


@pytest.mark.parametrize("name", ["trajgru", "convlstm"])
def test_serve_entry_point(name, monkeypatch):
    """``build_zoo_model`` is seeded and in eval mode; ``predict`` maps
    (B, 5, H, W) to (B, 20, H, W); the entry points are on the card unless
    the CPU is asked for, and raise without one."""
    model = serve.build_zoo_model(name, device="cpu", seed=3)
    assert not model.training
    again = serve.build_zoo_model(name, device="cpu", seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert float(model.enc_stage1.weight.abs().max()) > 0
    frames = np.random.default_rng(16).uniform(size=(1, 5, 32, 32)).astype(np.float32)
    out = serve.predict(model, frames)
    assert out.shape == (1, 20, 32, 32) and bool(torch.isfinite(out).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_zoo_model(name)
    cfg = recipes.apply_recipe(configs.shanghai_km_unet(), name, "pic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_state(cfg, engine.build_model(cfg), engine.build_optimizer(cfg, 10))


# --- one recipe step ----------------------------------------------------------


def _small_recipe_config(cfg):
    """The ("trajgru", "pic") recipe at 64^2, B=2, 5 -> 4 frames, fp32."""
    cfg.data.img_size = 64
    cfg.data.batch_size = 2
    cfg.data.seq_len = 9
    cfg.data.out_frames = 4
    cfg.model.num_classes = 4
    cfg.train.compute_dtype = "float32"
    return cfg


def _recipe_batch():
    """Input frames in [0, 1]; targets in [0, 50], across the thresholds."""
    rng = np.random.default_rng(17)
    batch = rng.random((2, 9, 64, 64), dtype=np.float32)
    batch[:, 5:] *= 50.0
    return batch


@pytest.fixture(scope="module")
def jax_trajgru_step():
    """JAX's step of the recipe (one compile, at XLA's default optimisation
    level 3, as tests/test_torch_train.py compiles the SH step): the initial
    parameters and the step's metrics, gradients and parameters after it."""
    cfg = _small_recipe_config(recipes_jax.apply_recipe(configs_jax.shanghai_km_unet(),
                                                        "trajgru", "pic"))
    model = engine_jax.build_model(cfg)
    tx = _recording(engine_jax.build_optimizer(cfg, steps_per_epoch=10))
    state = engine_jax.init_state(cfg, model, tx, jax.random.PRNGKey(0))
    # The flow convs scaled by 30, so that the warp samples between pixels:
    # the seeded init's flows reach 0.11 px at enc_rnn1, 0.006 px at fore_rnn1.
    params = jax.tree.map(lambda a: a, state.params)  # a copy to edit
    for name in ("enc_rnn1", "enc_rnn2", "enc_rnn3", "fore_rnn3", "fore_rnn2", "fore_rnn1"):
        params[name]["flows_conv"] = jax.tree.map(lambda a: a * 30.0, params[name]["flows_conv"])
    state = state.replace(params=params, opt_state=tx.init(params))
    initial = jax.device_get(params)
    step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                   compiler_options={"xla_backend_optimization_level": 3})
    state, m = step(state, jnp.asarray(_recipe_batch()), jax.random.PRNGKey(3))
    want = jax.device_get({"metrics": (float(m["loss"]), float(m["grad_norm"])),
                           "grads": state.opt_state[1],
                           "after": {"params": state.params, "batch_stats": {}}})
    assert np.isfinite(want["metrics"]).all()
    return initial, want


def test_trajgru_recipe_step_matches_jax(jax_trajgru_step):
    """One step of the ("trajgru", "pic") recipe (Adam lr 1e-4,
    weighted_mse_mae over the thresholds, MultiStepLR) from JAX's initial
    parameters: the loss and grad norm within 1e-4 relative; the gradients
    leaf by leaf within GRAD_RTOL of each leaf's largest; the parameters
    after it within 1e-4 plus what the two gradients make of Adam's first
    update (tests/test_torch_train.py's ``_assert_step_matches``)."""
    initial, want = jax_trajgru_step
    cfg = _small_recipe_config(recipes.apply_recipe(configs.shanghai_km_unet(),
                                                    "trajgru", "pic"))
    model = engine.build_model(cfg)
    assert isinstance(model, ef.TrajGRU_EF)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, device="cpu")
    convert.load_flax(model, initial)
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.clone() for g in grads]) or update(
        grads, st, params)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    launches = (bilinear.bilinear_gather_multiview.launches,
                bilinear.bilinear_gather_multiview_backward.launches)
    state, m = step(state, _recipe_batch(), None)
    np.testing.assert_allclose((float(m["loss"]), float(m["grad_norm"])), want["metrics"],
                               rtol=1e-4, atol=0)
    zeros = {k: torch.zeros_like(p) for k, p in state.params.items()}
    _assert_step_matches(model, tx.lr(0), dict(zip(state.params, seen[0])),
                         {k: v.clone() for k, v in model.state_dict().items()}, want,
                         (0, zeros, zeros))
    assert (bilinear.bilinear_gather_multiview.launches,
            bilinear.bilinear_gather_multiview_backward.launches) == launches  # CPU: plain
    assert state.step == 1 and state.opt_state.count == 1
