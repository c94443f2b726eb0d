"""The zoo's five baselines against the JAX package, forward, on the CPU.

SmaAt-UNet, SCECA-Net, LPTQPN, TransUNet and Swin-UNet at
tests/test_zoo.py's narrow extras (``STACK_CASES``), 64^2, B=2, 5 -> 4
frames, fp32, with converted perturbed weights (tests/torch_parity.py):
the output within 1e-4 abs in eval mode (BatchNorm on its running
statistics) and in training mode (BatchNorm on the batch's statistics,
flax's; the running statistics after it within 1e-4 too), with every
dropout and stochastic depth at rate 0 (TransUNet's ``dropout`` and
Swin's ``drop_path_rate`` through ``model.extra``, SCECA's DenseLayer
rate monkeypatched on both sides: neither constructor exposes it). Then
the port's own dropouts by their statistics, the registry, the converter
on the new leaves, and the pieces with a quirk: XLA's "SAME" padding of a
strided conv, WSConv's standardisation, Swin's window clamp and shift mask.
Each JAX function is jitted, so that it compiles once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.models.sceca_net as sceca_net_jax
import kmunet_tpu.models.swin_unet as swin_unet_jax
import kmunet_tpu.models.transunet as transunet_jax
from kmunet_tpu.configs import ModelConfig as ModelConfigJax
from kmunet_tpu.models import zoo as zoo_jax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.models import sceca_net, swin_unet, transunet, zoo
from kmunet_tpu_torch.nn.layers import DropPath, Dropout, pad_same
from tests.test_zoo import STACK_CASES
from tests.torch_parity import init_perturbed, nchw, nhwc, one_torch_thread  # noqa: F401

ATOL = 1e-4
SIZE, BATCH, OUT = 64, 2, 4
BASELINES = ("smaat_unet", "sceca_net", "lptqpn", "transunet", "swin_unet")
# Rates 0: the steps and the training-mode forwards compare deterministic
# functions (JAX's dropout masks cannot be drawn in torch).
NO_DROP = {"transunet": {"dropout": 0.0}, "swin_unet": {"drop_path_rate": 0.0}}


def extras(name):
    (extra,) = [e for n, _, e in STACK_CASES if n == name]
    return {**extra, **NO_DROP.get(name, {})}


@pytest.fixture
def no_dense_dropout(monkeypatch):
    """SCECA's DenseLayer at dropout 0 on both sides."""
    class DenseLayer(sceca_net_jax.DenseLayer):
        dropout_rate: float = 0.0

    monkeypatch.setattr(sceca_net_jax, "DenseLayer", DenseLayer)
    monkeypatch.setattr(sceca_net.DenseLayer, "dropout_rate", 0.0)


def jax_model(name):
    return zoo_jax.build(ModelConfigJax(name=name, num_classes=OUT, extra=extras(name)))


def port_model(name):
    return zoo.build(configs.ModelConfig(name=name, num_classes=OUT, extra=extras(name)),
                     img_size=SIZE)


def inputs(seed=40):
    return np.random.default_rng(seed).uniform(size=(BATCH, SIZE, SIZE, 5)).astype(np.float32)


def variables_of(name, seed):
    """Perturbed flax variables (shapes traced once, nothing compiled)."""
    return init_perturbed(jax_model(name), jnp.zeros((1, SIZE, SIZE, 5)), seed=seed)


def _float64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_jax(name, train, no_dense_dropout):
    """Each baseline's output, and in training its BatchNorm statistics
    after the forward, against the JAX model's: in eval mode the fp32 port
    against JAX in fp32. In training the JAX model runs in float64
    (``jax.enable_x64``): its fp32 forward lies up to 2.4e-4 from its own
    float64 one at SmaAt-UNet's output, where the port's fp32 lies 6e-5
    (XLA's one-pass fp32 sums over the batch's 8192 pixels feed each
    BatchNorm); the fp32 port within 1e-4 of it, and the port in float64
    within 1e-9, the same function."""
    x = inputs()
    variables = variables_of(name, seed=41 + BASELINES.index(name))
    jm = jax_model(name)
    tm = port_model(name)
    convert.load_flax(tm, variables["params"], variables.get("batch_stats"))
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if not train:
        want = jax.jit(jm.apply)(variables, jnp.asarray(x))
        assert got.shape == want.shape == (BATCH, SIZE, SIZE, OUT)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=name)
        return
    fresh = port_model(name).double()
    convert.load_flax(fresh, variables["params"], variables.get("batch_stats"))
    with torch.no_grad():
        got64 = fresh.double().train()(torch.from_numpy(x).double())
    with jax.enable_x64(True):
        # level 3: XLA's float64 convs run 4-13x slower at the conftest's level 0
        run = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"],
                                            rngs={"dropout": jax.random.PRNGKey(0)}),
                      compiler_options={"xla_backend_optimization_level": 3})
        want, mutated = jax.device_get(run(_float64(variables), np.asarray(x, np.float64)))
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got64.numpy(), want, rtol=0, atol=1e-9, err_msg=name)
    if "batch_stats" in variables:
        stats = convert.to_state_dict(tm, variables["params"], mutated["batch_stats"])
        for key, value in tm.state_dict().items():
            if "running_" in key:
                np.testing.assert_allclose(value.numpy(), stats[key].numpy(), rtol=0,
                                           atol=ATOL, err_msg=key)


def test_zoo_builds_the_baselines_with_their_extras():
    """Each name builds its class with the JAX constructor's arguments from
    ``model.extra``; an unknown name raises ``ValueError`` as JAX's zoo
    does; the image size sizes TransUNet's position embeddings and
    Swin-UNet's windows; the stochastic models are the ones whose forward
    takes a generator."""
    built = {n: port_model(n) for n in BASELINES}
    assert [type(m).__name__ for m in built.values()] == [
        "SmaAt_UNet", "SCECANet", "LPTQPN", "TransUNet", "SwinUNet"]
    assert tuple(built["transunet"].position_embeddings.shape) == (1, 16, 64)
    full = zoo.build(configs.ModelConfig(name="transunet", num_classes=20), img_size=256)
    assert tuple(full.position_embeddings.shape) == (1, 256, 768)
    assert full.block11.drop.rate == 0.1
    windows = [(m.window, m.shift) for m in built["swin_unet"].modules()
               if isinstance(m, swin_unet.SwinBlock)]
    assert windows[:8] == [(8, 0), (8, 4), (8, 0), (8, 0), (4, 0), (4, 0), (2, 0), (2, 0)]
    with pytest.raises(ValueError, match="unknown model 'unet_9000'"):
        zoo.build(configs.ModelConfig(name="unet_9000"))
    with pytest.raises(ValueError, match="kan_fused and ssd_mixer"):
        zoo.build(configs.ModelConfig(name="swin_unet"), kan_fused=True)
    assert zoo.STOCHASTIC_MODELS == {"km_unet_v3", "sceca_net", "transunet", "swin_unet"}
    a = zoo.init_weights_(port_model("swin_unet"), torch.Generator().manual_seed(5))
    b = zoo.init_weights_(port_model("swin_unet"), torch.Generator().manual_seed(5))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    table = a.enc0_blk0.attn.relative_position_bias_table
    assert 0.0 < float(table.detach().abs().max()) <= 0.04  # truncated_normal(0.02)
    vit = zoo.init_weights_(port_model("transunet"), torch.Generator().manual_seed(5))
    assert float(vit.block0.fc1.bias.abs().max()) < 1e-5  # normal(1e-6)
    assert bool((vit.position_embeddings == 0).all())


def test_converter_is_strict_on_the_new_leaves():
    """The attention's DenseGeneral kernels flatten to linears, ECA's
    conv_kernel turns to a conv1d weight, LPTQPN's 0-d swish_beta stays
    0-d; a missing SRU gamma or an extra table fail."""
    params = variables_of("transunet", seed=50)["params"]
    state = convert.to_state_dict(port_model("transunet"), params,
                                  variables_of("transunet", seed=50)["batch_stats"])
    attn = params["block1"]["attn"]
    np.testing.assert_array_equal(state["block1.attn.query.weight"].numpy(),
                                  attn["query"]["kernel"].reshape(64, 64).T)
    np.testing.assert_array_equal(state["block1.attn.out.weight"].numpy(),
                                  attn["out"]["kernel"].reshape(64, 64).T)
    np.testing.assert_array_equal(state["block1.attn.key.bias"].numpy(),
                                  attn["key"]["bias"].reshape(-1))
    variables = variables_of("sceca_net", seed=51)
    model = port_model("sceca_net")
    state = convert.to_state_dict(model, variables["params"], variables["batch_stats"])
    eca = variables["params"]["sceca1"]["eca"]["conv_kernel"]
    np.testing.assert_array_equal(state["sceca1.eca.conv_weight"].numpy(), eca.transpose(2, 1, 0))
    sru = variables["params"]["sceca2"]["sru"]
    broken = {**variables["params"], "sceca2": {**variables["params"]["sceca2"], "sru": {
        k: v for k, v in sru.items() if k != "gamma"}}}
    with pytest.raises(KeyError, match="sceca2.sru.gamma"):
        convert.to_state_dict(model, broken, variables["batch_stats"])
    params = variables_of("lptqpn", seed=52)["params"]
    assert convert.to_state_dict(port_model("lptqpn"), params)["swish_beta"].shape == ()
    params = variables_of("swin_unet", seed=53)["params"]
    attn = params["enc0_blk0"]["attn"]
    extra = {**params, "enc0_blk0": {**params["enc0_blk0"], "attn": {
        **attn, "relative_position_bias_table2": attn["relative_position_bias_table"]}}}
    with pytest.raises(KeyError, match="enc0_blk0/attn/relative_position_bias_table2"):
        convert.to_state_dict(port_model("swin_unet"), extra)


@pytest.mark.parametrize("n,k,s", [(8, 3, 2), (15, 3, 2), (32, 3, 2), (63, 1, 2), (64, 4, 4)])
def test_pad_same_is_xla_same(n, k, s):
    """A strided conv on ``pad_same``'s padding equals XLA's 'SAME' conv,
    the odd pixel padded after."""
    rng = np.random.default_rng(60)
    x = rng.normal(size=(1, n, n + 1, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = torch.nn.functional.conv2d(pad_same(nchw(x), (k, k), (s, s)),
                                     torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), stride=s)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_wsconv_and_resnet_skips_match_jax():
    """WSConv standardises its kernel (biased variance, eps 1e-5) on every
    call; the stem's skips, zero-padded back to in_size / 4 and / 8 after
    the 3x3 stride-2 VALID max-pool, match JAX's ResNetV2 at 64^2."""
    x = inputs(61)[:, :, :, :5]
    jm = transunet_jax.ResNetV2(block_units=(1, 1, 1))
    variables = init_perturbed(jm, jnp.asarray(x), seed=62)
    feat, skips = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = transunet.ResNetV2(5, block_units=(1, 1, 1))
    convert.load_flax(tm, variables["params"])
    with torch.no_grad():
        got_feat, got_skips = tm(nchw(x))
    assert [tuple(s.shape[1:3]) for s in skips] == [(8, 8), (16, 16), (32, 32)]
    for g, w in zip([got_feat] + got_skips, [feat] + list(skips)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=ATOL)


def test_swin_window_pieces_match_jax():
    """The relative-position index, the shift mask, the window partition and
    its reverse against the JAX module's."""
    for w in (2, 4, 8):
        np.testing.assert_array_equal(swin_unet.relative_position_index(w),
                                      swin_unet_jax._rel_pos_index(w))
    np.testing.assert_array_equal(swin_unet.shift_mask(16, 16, 8, 4),
                                  swin_unet_jax._shift_mask(16, 16, 8, 4))
    x = np.random.default_rng(63).normal(size=(2, 16, 24, 3)).astype(np.float32)
    got = swin_unet.window_partition(torch.from_numpy(x), 8)
    want = swin_unet_jax.window_partition(jnp.asarray(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(swin_unet.window_reverse(got, 8, 16, 24).numpy(), x)


@pytest.mark.parametrize("layer", [Dropout, DropPath])
def test_dropouts_by_their_statistics(layer):
    """In training, the share dropped lies near the rate and a kept element
    is scaled by 1 / (1 - rate), from the caller's generator (the same
    generator state, the same mask); in eval mode the identity; without a
    generator in training, an error."""
    rate = 0.1 if layer is Dropout else 0.2
    m = layer(rate).train()
    x = torch.ones(4096, 8, 4, 4)
    g = torch.Generator().manual_seed(64)
    state = g.get_state()
    y = m(x, g)
    assert torch.unique(y).tolist() == [0.0, float(torch.tensor(1.0) / (1.0 - rate))]
    dropped = float((y == 0).float().mean())
    assert abs(dropped - rate) < 0.01, dropped
    if layer is DropPath:  # whole samples
        assert bool(((y == 0).flatten(1).all(1) | (y != 0).flatten(1).all(1)).all())
    g.set_state(state)
    assert torch.equal(m(x, g), y)
    with pytest.raises(ValueError, match="torch.Generator"):
        m(x)
    assert m.eval()(x) is x


def test_sceca_dropout_rate_is_the_class_attribute():
    """DenseLayer's dropout is 0.5, the JAX default, read when it is built."""
    assert port_model("sceca_net").dense.drop.rate == 0.5
    assert dataclasses.fields(sceca_net_jax.DenseLayer)[2].default == 0.5


def test_entry_points_are_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    """``build_zoo_model`` builds a baseline seeded, in eval mode, sized by
    ``img_size``, and forecasts (B, H, W, 5) -> (B, H, W, 20) on the CPU
    when asked; without a card it and ``engine.init_state`` raise."""
    from kmunet_tpu_torch import serve
    from kmunet_tpu_torch.train import engine, recipes

    model = serve.build_zoo_model("swin_unet", device="cpu", seed=2, img_size=32)
    again = serve.build_zoo_model("swin_unet", device="cpu", seed=2, img_size=32)
    assert not model.training
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    out = serve.predict(model, inputs(65)[:, :32, :32])
    assert out.shape == (BATCH, 32, 32, 20) and bool(torch.isfinite(out).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_zoo_model("smaat_unet")
    cfg = recipes.apply_recipe(configs.shanghai_km_unet(), "smaat_unet", "pic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_state(cfg, engine.build_model(cfg), engine.build_optimizer(cfg, 10))
