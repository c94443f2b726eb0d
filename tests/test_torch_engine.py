"""The port's training and evaluation loop on the CPU: ``parse_overrides``
against JAX's, checkpoints (orbax's retention, restore), the loop's best
and latest checkpoints, resume, early stop, ``nan_abort``, the plateau's
scale, the device-cache epoch and the CLI (``evaluate_checkpoint`` on the
repo's trained SH checkpoint against JAX's ``evaluate_model`` is in
tests/test_torch_engine_trained.py).

The port-only loops run the SH model at 32^2, B=2, 9 frames -> 4 (two
steps an epoch) on one torch thread. Where a test needs the val losses to
follow a script (a plateau, an early stop, a NaN), the eval step is wrapped
to return the script's loss of the epoch that the state's step count gives,
so that an interrupted and an uninterrupted run see the same script.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
from kmunet_tpu.train.checkpoint import CheckpointManager as CheckpointManagerJax
from kmunet_tpu_torch import configs
from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.checkpoint import CheckpointManager
from kmunet_tpu_torch.train.optimizers import ChainState, OptState


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(tmp_path=None, epochs=2, length=4, **train):
    """The SH recipe on synthetic data at 32^2, B=2, 9 -> 4 frames:
    ``length`` // 2 steps an epoch, val and test one batch each."""
    cfg = configs.shanghai_km_unet()
    cfg.data.name = "synthetic"
    cfg.data.img_size, cfg.data.batch_size = 32, 2
    cfg.data.seq_len, cfg.data.out_frames = 9, 4
    cfg.data.synthetic_length = length
    cfg.data.num_workers = 2
    cfg.model.num_classes = 4
    cfg.train.epochs = epochs
    cfg.train.vis_batches = 0
    if tmp_path is not None:
        cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


# --- parse_overrides ---------------------------------------------------------

ARGVS = {
    "typed": ["--train.lr=3e-4", "--data.img_size=128", "--model.embed_dims=8,16,32",
              "--mesh.fsdp=true", "--data.thresholds=10,50", "--train.resume=yes",
              "--train.remat=0", "--train.ckpt_dir=/tmp/x", "--data.name=laps",
              "--train.milestones=10,20", "--data.value_scale=1"],
    "dict_leaves": ["--model.extra.drop_path=0.0", "--model.extra.head_norm=false",
                    "--model.extra.c_list=(8, 16)", "--model.extra.tag=abc",
                    "--model.extra.flag=True"],
    "empty": [],
}
BAD_ARGVS = {"positional": (["lr=3"], ValueError), "no_value": (["--train.lr"], ValueError),
             "unknown_field": (["--train.nope=1"], AttributeError),
             "not_a_float": (["--train.lr=abc"], ValueError)}


@pytest.mark.parametrize("name", list(ARGVS))
def test_parse_overrides_matches_jax(name):
    for make in ("shanghai_km_unet", "laps_km_unet"):
        got = configs.parse_overrides(getattr(configs, make)(), ARGVS[name])
        want = configs_jax.parse_overrides(getattr(configs_jax, make)(), ARGVS[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "dict_leaves":
        assert got.model.extra == {"drop_path": 0.0, "head_norm": False, "c_list": (8, 16),
                                   "tag": "abc", "flag": True}


@pytest.mark.parametrize("name", list(BAD_ARGVS))
def test_parse_overrides_refuses_what_jax_refuses(name):
    argv, error = BAD_ARGVS[name]
    for parse, cfg in ((configs.parse_overrides, configs.shanghai_km_unet()),
                       (configs_jax.parse_overrides, configs_jax.shanghai_km_unet())):
        with pytest.raises(error):
            parse(cfg, argv)


@pytest.mark.parametrize("mesh", [{"data": 2}, {"spatial": 2}, {"model": 2}, {"fsdp": True}])
def test_a_mesh_of_more_than_one_device_is_refused(mesh, tmp_path):
    """In one process: a mesh of two devices, ``spatial`` = 2 among them,
    raises JAX's ``ValueError`` (``MeshSpec.resolve``: the world cannot fill
    it); ``fsdp`` on a 'model' axis of one shards nothing (JAX's rule) and
    the loop trains. Across ranks: tests/test_torch_data_parallel.py and
    tests/test_torch_spatial.py."""
    cfg = _small(tmp_path)
    for k, v in mesh.items():
        setattr(cfg.mesh, k, v)
    if "fsdp" in mesh:
        results = engine.train_and_evaluate(cfg, max_steps=1, device="cpu")
        assert results["steps"] == 1 and math.isfinite(results["test_loss"])
        return
    error, match = ValueError, r"1 devices not divisible by fixed axes"
    with pytest.raises(error, match=match):
        engine.train_and_evaluate(cfg, device="cpu")
    with pytest.raises(error, match=match):
        engine.evaluate_checkpoint(cfg, str(tmp_path), device="cpu")


# --- checkpoints -------------------------------------------------------------

def _tiny_state(seed, plateau=True):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g)}
    stats = {"bn.running_mean": torch.randn(4, generator=g)}
    inner = OptState(seed, [torch.randn_like(p) for p in params.values()],
                     [torch.rand_like(p) for p in params.values()])
    opt = ChainState(inner, 0.1 * seed) if plateau else inner
    return engine.TrainState(seed, params, stats, opt)


def _files(directory):
    """The steps of the checkpoint files in ``directory``."""
    return sorted(int(n[:-3]) for n in os.listdir(directory) if n.endswith(".pt"))


def test_checkpoint_retention_matches_orbax(tmp_path):
    """The same saves through orbax's manager (the JAX package's) and the
    port's: after each, the same steps kept, the same latest and best."""
    saves = [(1, 5.0), (2, 4.0), (3, 4.5), (4, 3.0), (5, 4.0), (6, 6.0), (7, 3.0), (8, 2.0),
             (9, 3.0)]
    ours = CheckpointManager(str(tmp_path / "port"))
    ref = CheckpointManagerJax(str(tmp_path / "jax"))
    for mgr in (ours, ref):
        assert mgr.restore_latest(None) == (None, None)
        assert mgr.restore_best(None) == (None, None)
    for step, val_loss in saves:
        ours.save(step, _tiny_state(step), val_loss)
        ref.save(step, {"w": np.full(2, step, np.float32)}, val_loss)
        ref.wait()
        kept = _files(ours.directory)
        assert kept == ours.all_steps() == sorted(ref._mgr.all_steps()), step
        assert ours.latest_step() == ref._mgr.latest_step()
        assert ours.best_step() == ref._mgr.best_step()
    ref.close()
    assert len(kept) == 3 and not [n for n in os.listdir(ours.directory) if "tmp" in n]
    assert sorted(os.listdir(ours.directory)) == sorted(["checkpoints.json"] +
                                                        [f"{s}.pt" for s in kept])
    step, raw = ours.restore_best(None)
    assert step == 8 and raw["val_loss"] == 2.0 and raw["step"] == 8


def test_checkpoint_restores_the_whole_state(tmp_path):
    """Parameters, buffers, the optimizer's count and slots, the plateau's
    scale and the step, copied into a state of the same shapes (whose
    tensors a model would alias); a state of other names is refused."""
    mgr = CheckpointManager(str(tmp_path))
    saved = _tiny_state(3)
    mgr.save(3, saved, 0.5, extra={"epoch": 7})
    state = _tiny_state(9)
    aliases = state.params["w"]
    step, restored = mgr.restore_latest(state)
    assert step == 3 and restored.step == 3 and mgr.extra(3) == {"epoch": 7}
    assert restored.params["w"] is aliases and torch.equal(aliases, saved.params["w"])
    for name in ("params", "batch_stats"):
        for k, v in getattr(saved, name).items():
            assert torch.equal(getattr(restored, name)[k], v)
    assert restored.opt_state.scale == saved.opt_state.scale == pytest.approx(0.3)
    assert restored.opt_state.inner.count == 3
    for a, b in zip(restored.opt_state.inner.mu + restored.opt_state.inner.nu,
                    saved.opt_state.inner.mu + saved.opt_state.inner.nu):
        assert torch.equal(a, b)
    other = _tiny_state(1)
    other.params["v"] = other.params.pop("w")
    with pytest.raises(ValueError, match="params"):
        mgr.restore(3, other)


# --- the loop ----------------------------------------------------------------

def _scripted_val(monkeypatch, script, steps_per_epoch=2):
    """The eval step's loss becomes ``script[epoch]``, the epoch that the
    state's step count gives (the test pass reads the last epoch's)."""
    make = engine.make_eval_step

    def make_scripted(model, loss_fn, cfg):
        fn = make(model, loss_fn, cfg)

        def step(state, batch):
            loss, pred, tgt = fn(state, batch)
            epoch = min(state.step // steps_per_epoch - 1, len(script) - 1)
            return torch.full_like(loss, script[epoch]), pred, tgt

        return step

    monkeypatch.setattr(engine, "make_eval_step", make_scripted)


def _final_state(monkeypatch):
    """Records the state that ``train_and_evaluate`` hands the test pass."""
    seen = []
    evaluate = engine.evaluate_model

    def recording(cfg, state, eval_step, loader):
        seen.append(state)
        return evaluate(cfg, state, eval_step, loader)

    monkeypatch.setattr(engine, "evaluate_model", recording)
    return seen


def _tensors(state):
    out = {f"p.{k}": v.clone() for k, v in state.params.items()}
    out.update({f"s.{k}": v.clone() for k, v in state.batch_stats.items()})
    inner = getattr(state.opt_state, "inner", state.opt_state)
    out.update({f"mu{i}": t.clone() for i, t in enumerate(inner.mu)})
    return out


def test_best_and_latest_checkpoints(tmp_path):
    """A checkpoint at each epoch whose val loss improves on the best so
    far (the three best kept); the latest is the newest kept; restored, the
    latest reproduces the in-memory test results bit for bit when it holds
    the final state. The vis strips, scatter CSV, results.json and epoch
    CSV are written."""
    cfg = _small(tmp_path, epochs=3, out_dir=str(tmp_path / "out"), vis_batches=1,
                 scatter_eval=True)
    results = engine.train_and_evaluate(cfg, log_csv=str(tmp_path / "epochs.csv"), device="cpu")
    val = results["history"]["val_loss"]
    improving = [2 * (e + 1) for e in range(3) if val[e] < min(val[:e], default=math.inf)]
    mgr = CheckpointManager(cfg.train.ckpt_dir)
    assert _files(mgr.directory) == improving
    assert mgr.latest_step() == improving[-1]
    assert mgr.best_step() == 2 * (int(np.argmin(val)) + 1)
    latest = engine.evaluate_checkpoint(cfg, cfg.train.ckpt_dir, which="latest", device="cpu")
    assert latest["checkpoint_step"] == improving[-1]
    if improving[-1] == 6:
        for key in ("test_loss", "RMSE", "SSIM", "FAR"):
            assert latest[key] == results[key], key
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "vis" / "batch_0_sample_1")) == ["gt.png", "input.png",
                                                                    "prediction.png"]
    assert (out / "scatter_metrics.csv").stat().st_size > 0
    written = json.loads((out / "results.json").read_text())
    assert written["checkpoint_step"] == improving[-1]  # evaluate_checkpoint rewrote it
    assert "scatter" in results and set(results["scatter"]) == set(cfg.data.thresholds)
    assert (tmp_path / "epochs.csv").read_text().count("\n") == 4
    with pytest.raises(ValueError, match="which"):
        engine.evaluate_checkpoint(cfg, cfg.train.ckpt_dir, which="first", device="cpu")
    with pytest.raises(FileNotFoundError):
        engine.evaluate_checkpoint(cfg, str(tmp_path / "empty"), device="cpu")


def test_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """A run stopped after epoch 2 (``epochs=3``) and resumed with
    ``resume`` from its latest checkpoint lands where the uninterrupted
    4-epoch run does, bit for bit: parameters, buffers, optimizer state,
    step count and the plateau's scale, with stochastic depth on. The
    scripted val losses trip the plateau (patience 0) at epoch 1, so the
    checkpoint of epoch 2 holds scale 0.5 and epoch 3 halves it again: a
    resume that reset the scale to 1 would differ."""
    script = [1.0, 1.0, 0.5, 0.5]
    _scripted_val(monkeypatch, script)
    final = _final_state(monkeypatch)
    train = dict(schedule="plateau", plateau_patience=0, plateau_factor=0.5)
    whole = engine.train_and_evaluate(_small(tmp_path / "whole", epochs=4, **train),
                                      device="cpu")
    assert final[-1].opt_state.scale == 0.25
    want = _tensors(final[-1])
    first = engine.train_and_evaluate(_small(tmp_path / "cut", epochs=3, **train), device="cpu")
    assert first["history"]["val_loss"] == script[:3]
    assert CheckpointManager(str(tmp_path / "cut" / "ckpt")).latest_step() == 6
    resumed = engine.train_and_evaluate(_small(tmp_path / "cut", epochs=4, resume=True, **train),
                                        device="cpu")
    state = final[-1]
    assert resumed["steps"] == whole["steps"] == state.step == 8
    assert state.opt_state.scale == 0.25 and state.opt_state.inner.count == 8
    assert resumed["history"]["val_loss"] == script[3:]
    assert resumed["history"]["train_loss"] == whole["history"]["train_loss"][3:]
    got = _tensors(state)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_early_stop(tmp_path, monkeypatch):
    _scripted_val(monkeypatch, [1.0, 1.25, 1.5, 1.75, 2.0], steps_per_epoch=1)
    cfg = _small(tmp_path, epochs=5, length=2, early_stop_patience=2)
    results = engine.train_and_evaluate(cfg, device="cpu")
    assert results["history"]["val_loss"] == [1.0, 1.25, 1.5] and results["steps"] == 3
    assert _files(cfg.train.ckpt_dir) == [1]


@pytest.mark.parametrize("nan_abort", [True, False])
def test_nan_abort(tmp_path, monkeypatch, nan_abort):
    """A non-finite val loss stops the loop under ``nan_abort``, and is
    never checkpointed."""
    _scripted_val(monkeypatch, [1.0, math.nan, 0.5], steps_per_epoch=1)
    cfg = _small(tmp_path, epochs=3, length=2, nan_abort=nan_abort)
    results = engine.train_and_evaluate(cfg, device="cpu")
    history = results["history"]["val_loss"]
    assert len(history) == (2 if nan_abort else 3) and math.isnan(history[1])
    assert _files(cfg.train.ckpt_dir) == ([1] if nan_abort else [1, 3])


def test_max_steps_cuts_the_epoch(tmp_path):
    results = engine.train_and_evaluate(_small(tmp_path, epochs=3, length=8), max_steps=3,
                                        device="cpu")
    assert results["steps"] == 3 and len(results["history"]["train_loss"]) == 1


def test_device_cache_epoch_equals_the_loader_epoch():
    """``make_epoch_runner`` on the corpus held as one tensor equals the
    step taken batch by batch on the same permutation (drawn from the same
    generator, which then feeds DropPath), bit for bit; ``make_val_epoch``
    is the mean of the eval steps in order."""
    cfg = _small()
    data = torch.from_numpy(np.random.default_rng(0).random((5, 9, 32, 32), dtype=np.float32))
    runs = []
    for cached in (True, False):
        model = engine.build_model(cfg)
        loss_fn = engine.build_loss(cfg)
        tx = engine.build_optimizer(cfg, 2)
        state = engine.init_state(cfg, model, tx, seed=1, device="cpu")
        gen = torch.Generator().manual_seed(3)
        if cached:
            state, loss = engine.make_epoch_runner(model, loss_fn, tx, cfg, 2)(state, data, gen)
        else:
            perm = torch.randperm(5, generator=gen)
            step = engine.make_train_step(model, loss_fn, tx, cfg)
            losses = []
            for i in range(2):
                state, m = step(state, data[perm[2 * i:2 * i + 2]], gen)
                losses.append(m["loss"])
            loss = torch.stack(losses).mean()
        val = engine.make_val_epoch(model, loss_fn, cfg, 2)(state, data)
        evals = [engine.make_eval_step(model, loss_fn, cfg)(state, data[i:i + 2])[0]
                 for i in (0, 2)]
        assert torch.equal(val, torch.stack(evals).mean())
        runs.append((loss, val, _tensors(state), state.step))
    (loss_a, val_a, a, step_a), (loss_b, val_b, b, step_b) = runs
    assert step_a == step_b == 2 and torch.equal(loss_a, loss_b) and torch.equal(val_a, val_b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_device_cache_loop(tmp_path):
    """``data.device_cache`` runs the loop through the epoch runner: the
    steps counted, a finite history, the test pass."""
    cfg = _small(tmp_path, epochs=2)
    cfg.data.device_cache = True
    results = engine.train_and_evaluate(cfg, device="cpu")
    assert results["steps"] == 4 and np.isfinite(results["history"]["train_loss"]).all()
    assert np.isfinite(results["test_loss"]) and 20 in results["threshold_metrics"]


def test_cli(tmp_path, capsys, monkeypatch):
    argv = ["--config=synthetic", "--max_steps=2", "--data.img_size=32", "--data.batch_size=2",
            "--data.synthetic_length=8", "--data.seq_len=9", "--data.out_frames=4",
            "--model.num_classes=4", "--train.epochs=1", "--data.num_workers=1",
            f"--train.out_dir={tmp_path}", "--train.vis_batches=0"]
    results = engine.main(argv, device="cpu")
    assert results["steps"] == 2 and np.isfinite(results["test_loss"])
    assert json.loads((tmp_path / "results.json").read_text())["dataset"] == "synthetic"
    assert "'test_loss'" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.main(argv)
