"""The input frame count reaches every stack model, on the CPU.

JAX's engine initialises a model on a dummy of ``cfg.data.in_frames``
frames (``kmunet_tpu/train/engine.py::init_state``), so flax sizes the first
conv from it. The port's ``engine.build_model`` passes it to ``zoo.build``:
each of the seven stack models (``km_unet_v3`` at its small widths, and
tests/test_zoo.py's ``STACK_CASES`` with their narrow extras) is built from
a config with ``in_frames=7``, goes through ``engine.init_state`` (seeded,
on the CPU), takes the JAX model's perturbed variables traced on that dummy
(tests/torch_parity.py) and forwards a (2, 32, 32, 7) batch in eval mode
within 1e-4 abs of the JAX model. The serve builders keep 5 frames.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kmunet_tpu.configs import ModelConfig as ModelConfigJax
from kmunet_tpu.models import zoo as zoo_jax
from kmunet_tpu_torch import configs, convert, serve
from kmunet_tpu_torch.train import engine
from tests.test_zoo import STACK_CASES
from tests.torch_parity import init_perturbed
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

IN_FRAMES, SIZE, BATCH = 7, 32, 2
CASES = [("km_unet_v3", 4, {"drop_path": 0.0})] + [
    (name, n, {**extra, **{"transunet": {"dropout": 0.0},
                           "swin_unet": {"drop_path_rate": 0.0}}.get(name, {})})
    for name, n, extra in STACK_CASES]
EMBED = (8, 16, 32)  # km_unet_v3's small widths


def _config(name, n, extra):
    cfg = configs.shanghai_km_unet()
    model = dataclasses.replace(cfg.model, name=name, num_classes=n, extra=dict(extra),
                                embed_dims=EMBED)
    data = dataclasses.replace(cfg.data, in_frames=IN_FRAMES, out_frames=n, img_size=SIZE)
    return dataclasses.replace(cfg, model=model, data=data)


@pytest.mark.parametrize("name,n,extra", CASES, ids=[c[0] for c in CASES])
def test_stack_model_takes_in_frames(name, n, extra):
    cfg = _config(name, n, extra)
    jm = zoo_jax.build(ModelConfigJax(name=name, num_classes=n, embed_dims=EMBED,
                                      extra=dict(extra)))
    x = np.random.default_rng(len(name)).uniform(
        size=(BATCH, SIZE, SIZE, IN_FRAMES)).astype(np.float32)
    variables = init_perturbed(jm, np.zeros((1, SIZE, SIZE, IN_FRAMES), np.float32),
                               seed=len(name))
    model = engine.build_model(cfg)
    engine.init_state(cfg, model, engine.build_optimizer(cfg, 10), device="cpu")
    convert.load_flax(model, variables["params"], variables.get("batch_stats"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)


def test_serve_builders_keep_five_frames():
    sh = serve.build_km_unet_v3_sh(device="cpu")
    assert sh.conv_f.in_channels == 5
    assert serve.build_zoo_model("mamba_unet", device="cpu").encoder1.weight.shape[1] == 5
