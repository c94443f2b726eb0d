"""The port's KM_UNetV3-SH against the JAX model, its converter, its seeded
init and its entry point, on the CPU.

The whole model runs at 32^2, B2, 5 -> 20 frames, embed_dims (16, 32, 64),
fp32, with perturbed weights, within 1e-4 abs (the per-layer bound of
BASELINE.json). The module-level defaults of the JAX package are pinned for
the run: the window DySample and the auto (XLA on the CPU) gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
from kmunet_tpu.models.km_unet import KM_UNetV3_SH as KM_UNetV3_SH_jax
from kmunet_tpu_torch import convert, serve
from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.models.km_unet import KM_UNetV3_SH
from tests.torch_parity import init_perturbed, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SHAPE = (2, 32, 32, 5)


@pytest.fixture(scope="module")
def jax_model_and_variables():
    mp = pytest.MonkeyPatch()
    mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
    mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
    model = KM_UNetV3_SH_jax(num_classes=20, embed_dims=(16, 32, 64))
    x = np.random.default_rng(0).uniform(size=SHAPE).astype(np.float32)
    variables = init_perturbed(model, jnp.asarray(x), seed=3)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))  # one compile
    yield variables, x, want
    mp.undo()


def test_full_model_matches_jax(jax_model_and_variables):
    variables, x, want = jax_model_and_variables
    model = port(KM_UNetV3_SH(num_classes=20, embed_dims=(16, 32, 64)), variables)
    before = bilinear.bilinear_gather.launches
    got = serve.predict(model, x).numpy()
    assert bilinear.bilinear_gather.launches == before  # CPU: the plain version
    assert got.shape == (2, 32, 32, 20) and np.isfinite(got).all()
    assert want.std() > 0.05  # the perturbed model's output is not flat
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_converter_fills_every_key_and_uses_every_leaf(jax_model_and_variables):
    variables = jax_model_and_variables[0]
    model = KM_UNetV3_SH()
    sd = convert.to_state_dict(model, variables["params"], variables["batch_stats"])
    assert set(sd) == set(model.state_dict())
    n_flax = len(jax.tree.leaves(variables))
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == n_flax


def test_converter_rejects_unused_leaf(jax_model_and_variables):
    variables = jax_model_and_variables[0]
    params = dict(variables["params"])
    params["stray"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        convert.to_state_dict(KM_UNetV3_SH(), params, variables["batch_stats"])


def test_converter_rejects_unfilled_key(jax_model_and_variables):
    variables = jax_model_and_variables[0]
    with pytest.raises(KeyError, match="running_var"):
        convert.to_state_dict(KM_UNetV3_SH(), variables["params"], None)


def test_converter_rejects_shape_mismatch(jax_model_and_variables):
    variables = jax_model_and_variables[0]
    with pytest.raises(ValueError, match="conv_f"):
        convert.to_state_dict(KM_UNetV3_SH(embed_dims=(16, 32, 64), num_classes=3),
                              {**variables["params"], "conv_f": {
                                  "kernel": np.zeros((3, 3, 4, 16), np.float32),
                                  "bias": np.zeros(16, np.float32)}},
                              variables["batch_stats"])


def test_seeded_init_is_deterministic_with_jax_init_rules():
    a = serve.build_km_unet_v3_sh(device="cpu", seed=7)
    b = serve.build_km_unet_v3_sh(device="cpu", seed=7)
    c = serve.build_km_unet_v3_sh(device="cpu", seed=8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_f.weight"], sc["conv_f.weight"])
    vim = a.enc1_vim.height_block.vit_mamba
    assert torch.all(vim.alpha == 1e-4)
    assert torch.all(vim.dwconv1.BatchNorm_0.weight == 0)
    assert torch.all(vim.ffn.ConvBNAct_1.BatchNorm_0.weight == 0)
    assert torch.all((vim.mixer.A >= 1) & (vim.mixer.A <= 16))
    assert float(a.dec1_up.offset.weight.detach().std()) < 5e-3
    bound = 1 / np.sqrt(5 * 9)
    assert float(a.conv_f.weight.detach().abs().max()) <= bound
    assert not a.training


def test_build_defaults_to_the_card():
    if torch.cuda.is_available():
        model = serve.build_km_unet_v3_sh()
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_km_unet_v3_sh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_km_unet_v3_sh(device="cuda")


def test_predict_on_cpu_shape_and_range():
    model = serve.build_km_unet_v3_sh(device="cpu", seed=1)
    frames = np.random.default_rng(1).uniform(size=(1, 32, 32, 5)).astype(np.float32)
    out = serve.predict(model, frames)
    assert out.shape == (1, 32, 32, 20)
    assert bool(((out > 0) & (out < 1)).all())
