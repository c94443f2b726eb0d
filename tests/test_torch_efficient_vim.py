"""The EfficientViM classifier against the JAX package, on the CPU.

M1 at full width (embed 128/192/320, depths 2/2/2, N = 49/25/9) on a 64^2
input, B=2, as tests/test_classifier.py runs it, and the distillation
config ((16, 24, 32), depths (1, 1, 1), N = (16, 9, 4)), with converted,
perturbed weights (tests/torch_parity.py), through every ``ssd_mixer`` (on
the CPU K2 and K3 run their plain versions: the same function). The eval
forward (BatchNorm on its running statistics) in fp32 within 1e-4 abs.

Training mode is held in float64 on both sides (``jax.enable_x64``): at
64^2 the last stage's maps are 1 x 1, so each of its train-mode
BatchNorms takes two values per channel, and fp32 cancels there. M1's fp32
train-mode logits lie 0.44 (JAX) and 0.88 (the port) from float64; float64
JAX and float64 port agree within 5e-8 (measured). So: the train-mode
logits and the running statistics after them within 1e-4 abs, the
distillation pair (training returns it; eval returns its mean and keeps it
on ``logits_pair``), and the gradient of mean(out**2) in training leaf by
leaf within 1e-4 of each leaf's largest (measured: 1e-5 at most), the leaves
whose exact gradient is 0 within 1e-12 of the largest gradient of all (1.2e6,
the stem's first conv; the smallest nonzero leaf's is 1.6e-4): every
mixer's A (the softmax is shift-invariant per state) and each merge's
first BatchNorm bias (a per-channel constant that the next 1x1 conv passes
to a train-mode BatchNorm, which removes it).

Then the layers alone at the sizes where flax's strided "SAME" pads 0
before and 1 after (the stem at 224^2, the merge at 14^2 -> 7^2) and 1 and 1
(7^2 -> 4^2), and M2-M4's parameter trees, which the converter maps one to
one. Each JAX function is jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.models import efficient_vim as vim_jax
from kmunet_tpu.nn import layers as layers_jax
from kmunet_tpu_torch import convert
from kmunet_tpu_torch.models import efficient_vim
from kmunet_tpu_torch.nn import layers
from kmunet_tpu_torch.nn.init import init_module_
from kmunet_tpu_torch.nn.ssd import MIXERS
from tests.torch_parity import init_perturbed, nchw, nhwc, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4
CLASSES = 10
LEVEL3 = {"xla_backend_optimization_level": 3}
DISTILL = dict(num_classes=7, embed_dim=(16, 24, 32), depths=(1, 1, 1), state_dim=(16, 9, 4),
               distillation=True)


def _images(seed, size=64, batch=2):
    return np.random.default_rng(seed).random((batch, size, size, 3), dtype=np.float32)


@functools.cache
def _m1():
    """The JAX M1, its perturbed variables and an input batch."""
    jm = vim_jax.EfficientViM_M1(num_classes=CLASSES)
    x = _images(0)
    return jm, init_perturbed(jm, x, seed=1), x


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@functools.cache
def _m1_jax_outputs():
    """JAX M1's fp32 eval logits, and in float64 its train-mode logits and
    batch stats, and mean(out**2) and its gradient."""
    jm, v, x = _m1()
    y_eval = jax.jit(jm.apply)(v, x)

    def loss(params, stats, x):
        out, _ = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    with jax.enable_x64(True):
        y_train, upd = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
            *_f64((v, x)))
        lg = jax.jit(jax.value_and_grad(loss))(*_f64((v["params"], v["batch_stats"], x)))
    return (np.asarray(y_eval), np.asarray(y_train), jax.device_get(upd["batch_stats"]),
            jax.device_get(lg))


@pytest.mark.parametrize("ssd_mixer", MIXERS)
def test_m1_eval_forward_matches_jax(ssd_mixer):
    jm, v, x = _m1()
    model = port(efficient_vim.EfficientViM_M1(num_classes=CLASSES, ssd_mixer=ssd_mixer), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _m1_jax_outputs()[0], rtol=0, atol=ATOL)


def _check_running_stats(model, want_sd):
    moved = 0
    for key, buf in model.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[key].numpy(), rtol=0, atol=ATOL,
                                       err_msg=key)
            moved += 1
    assert moved == 2 * sum(1 for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("ssd_mixer", MIXERS)
def test_m1_train_forward_and_batch_stats_match_jax(ssd_mixer):
    jm, v, x = _m1()
    _, want, stats, _ = _m1_jax_outputs()
    model = port(efficient_vim.EfficientViM_M1(num_classes=CLASSES, ssd_mixer=ssd_mixer), v)
    model = model.double().train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _check_running_stats(model, convert.to_state_dict(
        efficient_vim.EfficientViM_M1(num_classes=CLASSES).double(), v["params"], stats))


ZERO_GRADIENT_SUFFIXES = (".mixer.A", ".ConvBNAct_0.BatchNorm_0.bias")


def test_m1_gradients_match_jax():
    """d mean(out**2) / d params in training, leaf by leaf, in float64 (the
    module docstring's bounds); every other leaf's gradient is nonzero."""
    jm, v, x = _m1()
    want_loss, want = _m1_jax_outputs()[3]
    model = efficient_vim.EfficientViM_M1(num_classes=CLASSES).double()
    want_g = convert.to_state_dict(model, want, v["batch_stats"])
    largest = max(float(w.abs().max()) for w in want_g.values())
    model = port(model, v).train()
    got_loss = model(torch.from_numpy(x).double()).square().mean()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    zero = []
    for key, p in model.named_parameters():
        w = want_g[key]
        if key.endswith(ZERO_GRADIENT_SUFFIXES) and (key.startswith("merge") or "mixer" in key):
            zero.append(key)
            assert max(float(p.grad.abs().max()), float(w.abs().max())) <= 1e-12 * largest, key
            continue
        assert float(w.abs().max()) > 1e-12 * largest, key
        err = float((p.grad - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (key, err, float(w.abs().max()))
    assert len(zero) == 6 + 2  # six mixers' A, two merges' first BatchNorm bias


@pytest.mark.parametrize("ssd_mixer", MIXERS)
def test_distillation_pair_matches_jax(ssd_mixer):
    jm = vim_jax.EfficientViM(**DISTILL)
    x = _images(2)
    v = init_perturbed(jm, x, seed=3)
    z_eval, state = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))(v, x)
    with jax.enable_x64(True):
        (z, z_dist), upd = jax.jit(functools.partial(jm.apply, train=True,
                                                     mutable=["batch_stats"]))(*_f64((v, x)))
    model = port(efficient_vim.EfficientViM(**DISTILL, ssd_mixer=ssd_mixer), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        pair = model.logits_pair
        model.double().train()
        got_z, got_dist = model(torch.from_numpy(x).double())
    np.testing.assert_allclose(got.numpy(), np.asarray(z_eval), rtol=0, atol=ATOL)
    for g, w in zip(pair, state["intermediates"]["logits_pair"][0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_dist.numpy(), np.asarray(z_dist), rtol=0, atol=ATOL)
    _check_running_stats(model, convert.to_state_dict(
        efficient_vim.EfficientViM(**DISTILL).double(), v["params"], upd["batch_stats"]))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", ["stem_224", "merge_14", "merge_7"])
def test_strided_layers_match_jax(case, train):
    """The stem and the patch merge at the classifier's even and odd sizes:
    flax's strided SAME pads (0, 1) at an even size and (1, 1) at an odd one
    (``pad_same``)."""
    if case == "stem_224":
        jm, tm, shape = layers_jax.Stem(dim=32), layers.Stem(3, 32), (1, 224, 224, 3)
    else:
        size = int(case.split("_")[1])
        jm, tm, shape = (layers_jax.PatchMerging(out_dim=24), layers.PatchMerging(16, 24),
                         (2, size, size, 16))
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    v = init_perturbed(jm, x, seed=6)
    if train:
        want, _ = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(v, x)
    else:
        want = jax.jit(jm.apply)(v, x)
    tm = port(tm, v).train(train)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_squeeze_excite_and_conv1x1_match_jax():
    x = np.random.default_rng(7).normal(size=(2, 5, 5, 12)).astype(np.float32)
    for jm, tm in ((layers_jax.SqueezeExcite(), layers.SqueezeExcite(12)),
                   (layers_jax.Conv1x1(features=8), layers.Conv1x1(12, 8)),
                   (layers_jax.Conv1x1(features=8, use_bias=False),
                    layers.Conv1x1(12, 8, use_bias=False))):
        v = init_perturbed(jm, x, seed=8)
        with torch.no_grad():
            got = nhwc(port(tm, v)(nchw(x)))
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant", ["m2", "m3", "m4"])
def test_variant_trees_convert_one_to_one(variant):
    """Every leaf of the JAX M2-M4 maps to one key of the port's and back
    (``to_state_dict`` is strict both ways), with the same shape; the
    seeded init of the port runs."""
    jm = getattr(vim_jax, f"EfficientViM_{variant.upper()}")(num_classes=CLASSES)
    v = init_perturbed(jm, np.zeros((1, 64, 64, 3), np.float32))
    model = efficient_vim.VARIANTS[variant](num_classes=CLASSES)
    convert.load_flax(model, v["params"], v["batch_stats"])
    init_module_(model, torch.Generator().manual_seed(0))
    assert float(model.head3.weight.abs().max()) <= 0.04  # truncated_normal(0.02)
