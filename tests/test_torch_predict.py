"""``scripts/torch_predict.py`` (the port of scripts/predict.py) on the CPU,
against the JAX forward.

A port checkpoint is made from a JAX state (perturbed flax variables of the
SH model, converted): ``torch_predict.py --device=cpu`` restores it, runs the
synthetic test split's inputs and writes ``predictions.npz`` with the JAX
script's keys, shapes and dtypes; its ``pred`` is the JAX model's forward on
that state, clipped to [0, 1], within 1e-4.
"""

import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.data import SyntheticNowcastDataset as SyntheticJax
from kmunet_tpu_torch import configs
from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.checkpoint import CheckpointManager
from tests.torch_parity import init_perturbed, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--config=synthetic", "--data.img_size=32", "--data.synthetic_length=8",
        "--data.batch_size=2", "--data.num_workers=1"]
STEP = 7


def _configs():
    cfg = configs.shanghai_km_unet()
    cfg_jax = configs_jax.shanghai_km_unet()
    for c, parse in ((cfg, configs.parse_overrides), (cfg_jax, configs_jax.parse_overrides)):
        c.data.name = "synthetic"
        parse(c, ARGS[1:])
    return cfg, cfg_jax


@pytest.fixture(scope="module")
def predicted(tmp_path_factory):
    """The script's output on a checkpoint of a JAX state, and that state."""
    tmp = tmp_path_factory.mktemp("predict")
    cfg, cfg_jax = _configs()
    model_jax = engine_jax.build_model(cfg_jax)
    d = cfg.data
    x = jnp.zeros((d.batch_size, d.img_size, d.img_size, d.in_frames))
    variables = init_perturbed(model_jax, x, seed=5)
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=1)
    state = engine.init_state(cfg, model, tx, seed=0, device="cpu")
    port(model, variables)  # in place: the state's tensors hold the JAX state
    CheckpointManager(str(tmp / "ckpt")).save(STEP, state, 0.25)
    script = runpy.run_path(os.path.join(REPO, "scripts", "torch_predict.py"),
                            run_name="torch_predict")
    path = script["main"]([f"--ckpt={tmp / 'ckpt'}", f"--out={tmp / 'out'}", "--device=cpu",
                           *ARGS])
    return np.load(path), variables, model_jax, cfg_jax


def test_predictions_have_the_jax_scripts_keys(predicted):
    out, _, _, cfg_jax = predicted
    d = cfg_jax.data
    n = max(d.synthetic_length // 4, d.batch_size) // d.batch_size * d.batch_size
    assert set(out.files) == {"pred", "checkpoint_step", "in_frames", "model"}
    assert out["pred"].shape == (n, d.out_frames, d.img_size, d.img_size)
    assert out["pred"].dtype == np.float32
    assert int(out["checkpoint_step"]) == STEP
    assert int(out["in_frames"]) == d.in_frames == 5
    assert str(out["model"]) == cfg_jax.model.name


def test_predictions_match_the_jax_forward(predicted, monkeypatch):
    out, variables, model_jax, cfg_jax = predicted
    monkeypatch.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
    monkeypatch.setattr(sample_jax, "USE_PALLAS_GATHER", None)
    d = cfg_jax.data
    test_ds = SyntheticJax(length=max(d.synthetic_length // 4, d.batch_size),
                           img_size=d.img_size, seq_len=d.seq_len, seed=2)
    frames = np.stack([test_ds[i] for i in range(len(test_ds))])[:, :d.in_frames]
    want = jax.jit(model_jax.apply)(variables, jnp.asarray(frames.transpose(0, 2, 3, 1)))
    want = np.clip(np.asarray(want, np.float32).transpose(0, 3, 1, 2), 0.0, 1.0)
    assert want.std() > 0.05  # the perturbed model's output is not flat
    np.testing.assert_allclose(out["pred"], want, rtol=0, atol=1e-4)
