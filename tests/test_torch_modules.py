"""Layers of the port against their flax counterparts, fp32 on the CPU.

Each case builds the flax module at a small width, replaces every parameter
and BN statistic by seeded random values (tests/torch_parity.py), converts
them with ``kmunet_tpu_torch.convert`` and holds the port's output to the
JAX output within 1e-4 abs (the per-layer bound of BASELINE.json). BN runs
on its running statistics (eval).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.models.km_unet as km_jax
from kmunet_tpu.nn import attention as attention_jax
from kmunet_tpu.nn import dagem as dagem_jax
from kmunet_tpu.nn import kan as kan_jax
from kmunet_tpu.nn import layers as layers_jax
from kmunet_tpu.nn import resample as resample_jax
from kmunet_tpu.nn import ssd as ssd_jax
from kmunet_tpu.nn import wavelet as wavelet_jax
from kmunet_tpu_torch.models import km_unet
from kmunet_tpu_torch.nn import attention, dagem, kan, layers, resample, ssd, wavelet
from tests.torch_parity import init_perturbed, nchw, nhwc, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4


def _image(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check_nhwc(jax_module, torch_module, x, seed=0, **apply_kw):
    """Run both on the NHWC image ``x``; the port takes and returns NCHW."""
    variables = init_perturbed(jax_module, jnp.asarray(x), seed=seed, **apply_kw)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x), **apply_kw))
    with torch.no_grad():
        got = nhwc(port(torch_module, variables)(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("features,padding", [(8, 1), (5, 0)])
def test_kanconv2d(features, padding):
    x = _image((2, 6, 7, 4))
    _check_nhwc(kan_jax.KANConv2d(features, kernel_size=3, padding=padding),
                kan.KANConv2d(4, features, kernel_size=3, padding=padding), x)


def test_channel_layer_norm():
    x = _image((2, 3, 4, 6))
    _check_nhwc(layers_jax.ChannelLayerNorm(), layers.ChannelLayerNorm(6), x)


@pytest.mark.parametrize("groups", [1, 6])
def test_conv_bn_act(groups):
    x = _image((2, 5, 5, 6))
    _check_nhwc(layers_jax.ConvBNAct(6, (3, 3), groups=groups),
                layers.ConvBNAct(6, 6, (3, 3), groups=groups), x, train=False)


def test_ffn():
    x = _image((2, 4, 4, 6))
    _check_nhwc(layers_jax.FFN(12), layers.FFN(6, 12), x, train=False)


def test_hsmssd():
    B, side, C, N = 2, 4, 8, 16
    tokens = _image((B, side * side, C))
    m = ssd_jax.HSMSSD(d_model=C, state_dim=N)
    variables = init_perturbed(m, jnp.asarray(tokens))
    want_y, want_h = m.apply(variables, jnp.asarray(tokens))
    x = torch.from_numpy(tokens.transpose(0, 2, 1).reshape(B, C, side, side).copy())
    with torch.no_grad():
        got_y, got_h = port(ssd.HSMSSD(C, state_dim=N), variables)(x)
    np.testing.assert_allclose(nhwc(got_y), np.asarray(want_y), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)


def test_efficient_vim_block():
    x = _image((2, 4, 4, 8))
    _check_nhwc(ssd_jax.EfficientViMBlock(dim=8, state_dim=16),
                ssd.EfficientViMBlock(8, state_dim=16), x, train=False)


def test_channel_attention():
    _check_nhwc(attention_jax.ChannelAttention(4), attention.ChannelAttention(16, 4),
                _image((2, 3, 3, 16)))


def test_local_contrast_attention():
    _check_nhwc(attention_jax.LocalContrastAttention(), attention.LocalContrastAttention(8),
                _image((2, 4, 4, 8)))


def test_triple_norm():
    _check_nhwc(attention_jax.TripleNorm(), attention.TripleNorm(8), _image((2, 4, 5, 8)))


@pytest.mark.parametrize("mode", ["height", "width", "channel"])
def test_direction_attention(mode):
    _check_nhwc(attention_jax.DirectionAttention(mode), attention.DirectionAttention(8),
                _image((2, 4, 4, 8)))


def test_multi_scale_fusion():
    feats = [_image((2, 6, 6, c), seed=i) for i, c in enumerate((4, 8, 8))]
    m = attention_jax.MultiScaleFusion(channels=(4, 8, 8))
    variables = init_perturbed(m, [jnp.asarray(f) for f in feats])
    want = m.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port(attention.MultiScaleFusion((4, 8, 8)), variables)([nchw(f) for f in feats])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=ATOL)


def test_intelligent_wavelet_pooling():
    _check_nhwc(wavelet_jax.IntelligentWaveletPooling(),
                wavelet.IntelligentWaveletPooling(4), _image((2, 6, 8, 4)))


def test_dysample_window_path():
    _check_nhwc(resample_jax.DySample(scale=2, style="lp", groups=4, window=True),
                resample.DySample(8, scale=2, groups=4), _image((2, 4, 5, 8)))


def test_deform_conv2d():
    B, H, W, C, F = 2, 5, 6, 4, 6
    x = _image((B, H, W, C))
    offset = 2.0 * _image((B, H, W, 18), seed=1)  # taps land outside and between pixels
    m = resample_jax.DeformConv2d(F)
    variables = init_perturbed(m, jnp.asarray(x), jnp.asarray(offset))
    want = m.apply(variables, jnp.asarray(x), jnp.asarray(offset))
    with torch.no_grad():
        got = port(resample.DeformConv2d(C, F), variables)(torch.from_numpy(x),
                                                           torch.from_numpy(offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_dagem_eval():
    _check_nhwc(dagem_jax.DAGEM(), dagem.DAGEM(8), _image((2, 4, 4, 8)), train=False)


@pytest.mark.parametrize("c_in,features", [(4, 8), (8, 8)])
def test_stable_hybrid_kan_conv(c_in, features):
    _check_nhwc(km_jax.StableHybridKANConv(features), km_unet.StableHybridKANConv(c_in, features),
                _image((2, 5, 5, c_in)))


@pytest.mark.parametrize("mode", ["height", "width", "channel"])
def test_direction_vim(mode):
    _check_nhwc(km_jax.DirectionViM(mode), km_unet.DirectionViM(8, mode),
                _image((2, 4, 4, 8)), train=False)


def test_enhanced_vim_block():
    _check_nhwc(km_jax.EnhancedViMBlock(impl="separate"), km_unet.EnhancedViMBlock(8),
                _image((2, 4, 4, 8)), train=False)
