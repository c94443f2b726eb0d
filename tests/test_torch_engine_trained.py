"""``evaluate_checkpoint`` of the port on the repo's trained SH checkpoint
against JAX's ``evaluate_model`` on the restored state, on the CPU.

The contingency counts are exact only on identical predictions: the two
predictions differ by float noise here, and a pixel whose value straddles
a bin edge (floor(pred * value_scale)) lands on either side, so each count
may differ by at most the pixels that straddle its threshold, which are
counted (and held to a small share of the pixels).
"""

import dataclasses
import math
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.data import DataLoader as DataLoaderJax
from kmunet_tpu.metrics.evaluator import batch_metrics as batch_metrics_jax
from kmunet_tpu.train.checkpoint import CheckpointManager as CheckpointManagerJax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.metrics.evaluator import batch_metrics
from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.checkpoint import CheckpointManager

REPO = pathlib.Path(__file__).resolve().parent.parent
TRAINED_SH = REPO / "outputs/quality_table/km_unet_v3/ckpt/1264"
EVAL_RTOL = 1e-4
STRADDLE_SHARE = 1e-3  # of the test pass's pixels, at most, per threshold


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trained_config(cfg):
    """The trained SH model's recipe (5 -> 20 frames) on the synthetic test
    split at 32^2: two batches of 2."""
    cfg.data.name = "synthetic"
    cfg.data.img_size, cfg.data.batch_size = 32, 2
    cfg.data.synthetic_length = 16
    cfg.data.num_workers = 1
    return cfg


def test_evaluate_checkpoint_on_the_trained_sh_model_matches_jax(tmp_path):
    """The repo's trained SH checkpoint, copied under ``tmp_path`` and
    restored with orbax, converted and saved as the port's checkpoint:
    ``evaluate_checkpoint`` on the synthetic test split against JAX's
    ``evaluate_model`` on the restored state. The test loss, RMSE and SSIM
    within 1e-4 relative; each contingency count within the pixels that
    straddle its threshold between the two predictions."""
    shutil.copytree(TRAINED_SH, tmp_path / "orbax" / TRAINED_SH.name)
    manager = CheckpointManagerJax(str(tmp_path / "orbax"))
    step, restored = manager.restore_latest(None)
    manager.close()
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             {"params": restored["params"], "batch_stats": restored["batch_stats"]})

    preds = {}

    def recording(side, fn):
        def step(state, batch):
            loss, pred, tgt = fn(state, batch)
            preds.setdefault(side, []).append(np.asarray(pred, np.float32))
            return loss, pred, tgt

        return step

    cfg_jax = _trained_config(configs_jax.shanghai_km_unet())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        model_jax = engine_jax.build_model(cfg_jax)
        state_jax = engine_jax.TrainState(step=jnp.asarray(step),
                                          params=jax.tree.map(jnp.asarray, variables["params"]),
                                          batch_stats=jax.tree.map(jnp.asarray,
                                                                   variables["batch_stats"]),
                                          opt_state=None)
        loader_jax = DataLoaderJax(engine_jax.build_datasets(cfg_jax)[2], 2, num_workers=1,
                                   process_index=0, process_count=1)
        eval_jax = recording("jax", engine_jax.make_eval_step(model_jax,
                                                              engine_jax.build_loss(cfg_jax),
                                                              cfg_jax))
        want = engine_jax.evaluate_model(cfg_jax, state_jax, eval_jax, loader_jax)

    cfg = _trained_config(configs.shanghai_km_unet())
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, 1)
    state = engine.init_state(cfg, model, tx, device="cpu")
    convert.load_flax(model, variables["params"], variables["batch_stats"])
    CheckpointManager(str(tmp_path / "port")).save(step, dataclasses.replace(state, step=step),
                                                   0.0)
    make = engine.make_eval_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "make_eval_step", lambda *a: recording("port", make(*a)))
        got = engine.evaluate_checkpoint(cfg, str(tmp_path / "port"), device="cpu")

    assert got["checkpoint_step"] == step == int(TRAINED_SH.name)
    assert len(preds["port"]) == len(preds["jax"]) == 2
    for key in ("test_loss", "RMSE", "SSIM"):
        np.testing.assert_allclose(got[key], want[key], rtol=EVAL_RTOL, err_msg=key)
    np.testing.assert_allclose(got["per_horizon"]["RMSE"], want["per_horizon"]["RMSE"],
                               rtol=EVAL_RTOL)
    pred, pred_jax = np.concatenate(preds["port"]), np.concatenate(preds["jax"])
    assert pred.std() > 1e-3  # the trained model's answer is not constant
    for thr in cfg.data.thresholds:
        a, b = (np.floor(np.clip(p, 0, 1) * np.float32(90.0)) >= thr for p in (pred, pred_jax))
        straddle = int(np.sum(a != b))
        assert straddle <= STRADDLE_SHARE * pred.size, (thr, straddle)
        for k in ("CSI", "POD", "HSS"):
            g, w = got["threshold_metrics"][thr][k], want["threshold_metrics"][thr][k]
            assert (math.isnan(g) and math.isnan(w)) or straddle or g == w, (thr, k)
    # The counts themselves, from each side's predictions.
    tgt = np.concatenate([engine_jax.build_datasets(cfg_jax)[2][i][5:] for i in range(4)]
                         ).reshape(pred.shape)
    thresholds = tuple(cfg.data.thresholds)
    cont = batch_metrics(torch.from_numpy(tgt), torch.from_numpy(pred), thresholds, 90.0)["cont"]
    cont_jax = np.asarray(batch_metrics_jax(jnp.asarray(tgt), jnp.asarray(pred_jax), thresholds,
                                            90.0)["cont"])
    cont, cont_jax = cont.numpy().sum(axis=(1, 2)), cont_jax.sum(axis=(1, 2))
    straddles = np.array([int(np.sum((np.floor(np.clip(pred, 0, 1) * np.float32(90.0)) >= t)
                                     != (np.floor(np.clip(pred_jax, 0, 1) * np.float32(90.0))
                                         >= t))) for t in thresholds])
    assert (np.abs(cont - cont_jax) <= straddles[:, None]).all()
