"""The port's whole loop against JAX's ``train_and_evaluate``, on the CPU.

Both sides train the SH model at the 32^2, B=8, 9-frame, 4-output config of
tests/test_sharding_parity.py for 2 epochs of 1 step (synthetic data, the
same batches: the loaders' permutations are the same) with SGD (AdamW's
first update is about lr whatever |g|, so it would amplify rounding noise;
ROADMAP's rules), from the same initial variables: seeded random values
(``init_perturbed``) that each side's ``init_state`` is monkeypatched to
load. The epochs' losses agree within the train step's bound (1e-4
relative, tests/test_torch_train.py), and so do the test pass's loss, RMSE
and SSIM. The contingency counts are exact only on identical predictions:
here the two predictions differ by float noise, and a pixel whose value
straddles a bin edge (floor(pred * value_scale)) lands on either side, so
each count may differ by at most the pixels that straddle its threshold,
which are counted. results.json has JAX's keys.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.metrics import Evaluator as EvaluatorJax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.metrics import Evaluator
from kmunet_tpu_torch.train import engine
from tests.torch_parity import init_perturbed

LOSS_RTOL = 1e-4  # the train step's bound on the loss (tests/test_torch_train.py)
METRIC_RTOL = 1e-4
STRADDLE_SHARE = 1e-3  # of the test pass's pixels, at most, per threshold


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cfg, out_dir):
    cfg.data.name = "synthetic"
    cfg.data.img_size, cfg.data.batch_size = 32, 8
    cfg.data.seq_len, cfg.data.out_frames = 9, 4
    cfg.data.synthetic_length = 8  # 1 step per epoch; val and test 1 batch each
    cfg.data.num_workers = 2
    cfg.model.num_classes = 4
    cfg.model.extra["drop_path"] = 0.0  # the two sides' generators draw differently
    cfg.train.optimizer = "sgd"
    cfg.train.epochs = 2
    cfg.train.out_dir = str(out_dir)
    cfg.train.scatter_eval = True
    cfg.train.vis_batches = 0
    return cfg


class _Recorder:
    """Each side's eval steps' (pred, target) as numpy, and its Evaluators."""

    def __init__(self):
        self.preds, self.evaluators = [], []

    def eval_step(self, make):
        def wrapped(*args):
            fn = make(*args)

            def step(state, batch):
                loss, pred, tgt = fn(state, batch)
                self.preds.append((np.asarray(pred, np.float32), np.asarray(tgt, np.float32)))
                return loss, pred, tgt

            return step

        return wrapped

    def evaluator(self, cls):
        recorder = self

        class Recording(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                recorder.evaluators.append(self)

        return Recording


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's train_and_evaluate: (results, results.json,
    epoch CSV rows, recorder) of each."""
    tmp = tmp_path_factory.mktemp("loop")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        cfg = _config(configs_jax.shanghai_km_unet(), tmp / "jax")
        variables = init_perturbed(engine_jax.build_model(cfg), jnp.zeros((1, 32, 32, 5)),
                                   seed=11)

        def init_jax(cfg, model, tx, rng):
            params = jax.tree.map(jnp.asarray, variables["params"])
            return engine_jax.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                         batch_stats=jax.tree.map(jnp.asarray,
                                                                  variables["batch_stats"]),
                                         opt_state=tx.init(params))

        init_port = engine.init_state

        def init_torch(cfg, model, tx, seed=0, device=None):
            state = init_port(cfg, model, tx, seed=seed, device=device)
            convert.load_flax(model, variables["params"], variables["batch_stats"])
            return state

        for side, module, init, evaluator in (("jax", engine_jax, init_jax, EvaluatorJax),
                                              ("port", engine, init_torch, Evaluator)):
            rec = _Recorder()
            mp.setattr(module, "init_state", init)
            mp.setattr(module, "make_eval_step", rec.eval_step(module.make_eval_step))
            mp.setattr(module, "Evaluator", rec.evaluator(evaluator))
            if side == "jax":
                results = module.train_and_evaluate(cfg, log_csv=str(tmp / "jax.csv"))
            else:
                cfg = _config(configs.shanghai_km_unet(), tmp / "port")
                results = module.train_and_evaluate(cfg, log_csv=str(tmp / "port.csv"),
                                                    device="cpu")
            with open(tmp / side / "results.json") as f:
                written = json.load(f)
            with open(tmp / f"{side}.csv") as f:
                rows = list(csv.DictReader(f))
            out[side] = (results, written, rows, rec)
    return out


def test_loop_history_matches_jax(runs):
    got, _, rows, _ = runs["port"]
    want, _, want_rows, _ = runs["jax"]
    assert got["steps"] == want["steps"] == 2
    for key in ("train_loss", "val_loss"):
        assert len(got["history"][key]) == 2
        np.testing.assert_allclose(got["history"][key], want["history"][key], rtol=LOSS_RTOL,
                                   atol=0, err_msg=key)
    assert got["history"]["train_loss"][1] != got["history"]["train_loss"][0]  # it trained
    assert [list(r) for r in rows] == [list(r) for r in want_rows]
    assert [r["epoch"] for r in rows] == ["0", "1"]


def _straddling(pred_a, pred_b, thresholds, value_scale):
    """Per threshold, the pixels whose binarized value differs between two
    predictions (a count may move by at most that many)."""
    a = np.floor(np.clip(pred_a, 0, 1) * np.float32(value_scale))
    b = np.floor(np.clip(pred_b, 0, 1) * np.float32(value_scale))
    return np.array([int(np.sum((a >= t) != (b >= t))) for t in thresholds])


def test_loop_test_pass_matches_jax(runs):
    got, _, _, rec = runs["port"]
    want, _, _, rec_jax = runs["jax"]
    (pred, tgt), (pred_jax, tgt_jax) = rec.preds[-1], rec_jax.preds[-1]
    np.testing.assert_array_equal(tgt, tgt_jax)  # the same test batch
    np.testing.assert_allclose(pred, pred_jax, rtol=0, atol=1e-4)
    for key in ("test_loss", "RMSE", "SSIM"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)
    thresholds = tuple(configs.shanghai_km_unet().data.thresholds)
    straddle = _straddling(pred, pred_jax, thresholds, 90.0)
    assert (straddle <= STRADDLE_SHARE * pred.size).all(), straddle
    cont, cont_jax = rec.evaluators[-1]._cont, rec_jax.evaluators[-1]._cont
    assert cont.sum() == cont_jax.sum() and cont[:, 0].sum() > 0
    assert (np.abs(cont - cont_jax) <= straddle[:, None]).all(), (cont - cont_jax, straddle)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_results_json_has_jax_keys(runs):
    _, written, _, _ = runs["port"]
    _, written_jax, _, _ = runs["jax"]
    assert _keys(written) == _keys(written_jax)
    assert written["dataset"] == "synthetic" and written["steps"] == 2
