"""KM_UNetV3's LAPS variant and ``head_norm`` in the port against the JAX
package, on the CPU.

The whole ``KM_UNetV3_LAPS`` (no bridge, align-corners bilinear x2 resizes,
5 -> 3 frames) and both variants with ``head_norm=False`` at 32^2, B2,
embed_dims (16, 32, 64), fp32, with converted, perturbed weights
(tests/torch_parity.py), within 1e-4 abs (the per-layer bound of
BASELINE.json); the strict converter across variants and heads;
and ``laps_km_unet()`` and ``zoo.build`` held to the JAX package's
(tests/test_torch_laps_step.py holds its train step). The JAX SH model takes
the window DySample and the XLA gather, as on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
from kmunet_tpu.models.km_unet import KM_UNetV3 as KM_UNetV3_jax
from kmunet_tpu.models.zoo import build as build_model_jax
from kmunet_tpu_torch import configs, convert, serve
from kmunet_tpu_torch.kernels import kanconv, ssd
from kmunet_tpu_torch.models import zoo
from kmunet_tpu_torch.models.km_unet import KM_UNetV3, KM_UNetV3_LAPS
from tests.torch_parity import init_perturbed, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4
SHAPE = (2, 32, 32, 5)
# (variant, head_norm, num_classes): the LAPS model as trained, and each
# variant without its head's GroupNorm.
CASES = {"laps": ("laps", True, 3), "laps_no_head_norm": ("laps", False, 3),
         "sh_no_head_norm": ("sh", False, 20)}


@pytest.fixture(scope="module")
def jax_forwards():
    """Each case's perturbed variables, the input and JAX's answer (one
    compile each)."""
    x = np.random.default_rng(0).uniform(size=SHAPE).astype(np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        for i, (name, (variant, head_norm, n)) in enumerate(CASES.items()):
            jm = KM_UNetV3_jax(num_classes=n, variant=variant, head_norm=head_norm)
            variables = init_perturbed(jm, jnp.asarray(x), seed=10 + i)
            out[name] = variables, np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    return x, out


@pytest.mark.parametrize("case", list(CASES))
def test_full_model_matches_jax(jax_forwards, case):
    x, out = jax_forwards
    variables, want = out[case]
    variant, head_norm, n = CASES[case]
    model = port(KM_UNetV3(num_classes=n, variant=variant, head_norm=head_norm), variables)
    assert (model.output_norm is not None) == head_norm
    assert hasattr(model, "bridge") == (variant == "sh")
    got = serve.predict(model, x).numpy()
    assert got.shape == (2, 32, 32, n) and np.isfinite(got).all()
    assert want.std() > 0.05  # the perturbed model's output is not flat
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_laps_kernel_paths_take_the_plain_versions_on_the_cpu(jax_forwards):
    """``kan_fused`` and ``ssd_mixer`` on the LAPS variant: the CPU runs the
    plain versions, so the answer is the default's, and no kernel is
    counted."""
    x, out = jax_forwards
    variables, want = out["laps"]
    counters = (kanconv.fused_kanconv, ssd.hsmssd_compress, ssd.hsmssd_mix)
    before = [c.launches for c in counters]
    for mixer in ("fused", "compress"):
        model = port(KM_UNetV3_LAPS(kan_fused=True, ssd_mixer=mixer), variables)
        np.testing.assert_allclose(serve.predict(model, x).numpy(), want, rtol=0, atol=ATOL)
    assert [c.launches for c in counters] == before


def test_converter_is_strict_across_variants_and_heads(jax_forwards):
    _, out = jax_forwards
    laps = out["laps"][0]
    sh_bare = out["sh_no_head_norm"][0]
    sd = convert.to_state_dict(KM_UNetV3_LAPS(), laps["params"], laps["batch_stats"])
    assert set(sd) == set(KM_UNetV3_LAPS().state_dict())
    assert not any(k.startswith(("bridge.", "dec1_up.", "dec2_up.", "dec3_up.")) for k in sd)
    n_flax = len(jax.tree.leaves(laps))
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == n_flax
    # An SH model wants the bridge and DySample's convs; a LAPS model takes none.
    with pytest.raises(KeyError, match="unfilled torch keys: .*bridge"):
        convert.to_state_dict(KM_UNetV3(num_classes=3), laps["params"], laps["batch_stats"])
    with pytest.raises(KeyError, match="unused flax leaves: .*bridge"):
        convert.to_state_dict(KM_UNetV3_LAPS(num_classes=20, head_norm=False),
                              sh_bare["params"], sh_bare["batch_stats"])
    # A head without GroupNorm has no output_norm, and a head with one wants it.
    with pytest.raises(KeyError, match="unused flax leaves: .*output_norm"):
        convert.to_state_dict(KM_UNetV3_LAPS(head_norm=False), laps["params"],
                              laps["batch_stats"])
    with pytest.raises(KeyError, match="unfilled torch keys: .*output_norm"):
        convert.to_state_dict(KM_UNetV3(num_classes=20), sh_bare["params"],
                              sh_bare["batch_stats"])


def test_laps_config_matches_jax():
    """``laps_km_unet()``: every field the port keeps has the JAX recipe's
    value (value_scale 1, thresholds on normalized values, 5 -> 3 frames at
    B=1, scatter_eval on)."""
    port_cfg, jax_cfg = configs.laps_km_unet(), configs_jax.laps_km_unet()
    for section in ("data", "model", "train"):
        p, j = getattr(port_cfg, section), getattr(jax_cfg, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(j, f.name), (section, f.name)
    assert port_cfg.data.thresholds == (0.1, 0.3, 0.5, 0.7, 0.8)
    assert port_cfg.model.variant == "laps" and port_cfg.train.scatter_eval


@pytest.mark.parametrize("head_norm", [True, False])
def test_zoo_builds_what_the_jax_zoo_builds(head_norm):
    """``zoo.build`` of the LAPS recipe's model config (with
    ``extra["head_norm"]``) takes exactly the variables of the JAX zoo's
    model, strictly."""
    cfg = configs.laps_km_unet()
    cfg.model.extra["head_norm"] = head_norm
    jcfg = configs_jax.laps_km_unet()
    jcfg.model.extra["head_norm"] = head_norm
    variables = init_perturbed(build_model_jax(jcfg.model), jnp.zeros((1, 16, 16, 5)))
    model = zoo.build(cfg.model)
    assert model.variant == "laps" and (model.output_norm is not None) == head_norm
    convert.load_flax(model, variables["params"], variables["batch_stats"])
    with pytest.raises(ValueError, match="no DySample"):
        zoo.build(cfg.model, dysample_window=False)
    cfg.model.extra["depth"] = 3
    with pytest.raises(ValueError, match="drop_path and head_norm"):
        zoo.build(cfg.model)


def test_build_laps_defaults_to_the_card():
    if torch.cuda.is_available():
        assert next(serve.build_km_unet_v3_laps().parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_km_unet_v3_laps()
    model = serve.build_km_unet_v3_laps(device="cpu", seed=1, head_norm=False)
    assert model.output_norm is None and not model.training
    out = serve.predict(model, np.random.default_rng(1).uniform(size=(1, 32, 32, 5)))
    assert out.shape == (1, 32, 32, 3) and bool(((out > 0) & (out < 1)).all())
