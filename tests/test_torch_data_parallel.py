"""The port's trainer across ranks (gloo on the CPU) against its run of one
process, which tests/test_torch_train.py holds to the JAX step.

At tests/test_sharding_parity.py's small config (32^2, B=8, 9 frames -> 4,
fp32, drop path 0.1), dp2, dp4, model2 with FSDP and dp2 x model2 with FSDP
take two steps on one global batch, each rank on its rows, step 2 from the
one process's state after step 1 (a checkpoint every rank restores, taking
its blocks, and the one process's generator state): the losses and grad
norms within 1e-5 relative, the step-1 gradients leaf by leaf within 2e-4
of the leaf's largest |gradient| (within the distance of either side's
fp32 gradient from float64) plus 1e-7 of the largest of all (the leaves
left by cancelling sums; those whose exact gradient is 0,
tests/test_torch_train.py's, below 1e-5 of the largest gradient of all on
both sides), the BatchNorm running buffers equal on every rank and within
1e-6 of the one process's, and the state after each step by ROADMAP's AdamW
rule: within 1e-6 of the leaf plus what the two steps' gradients make of
the update. The sharded leaves' blocks are compared with the one process's
blocks. Then the loop (``train_and_evaluate``, SGD, 2 epochs) under dp2
against one process, on the loader path and the device cache; a dp2
checkpoint scored in one process; an FSDP checkpoint restored in one
process. One spawn per world size runs every case of that size.
"""

import math

import numpy as np
import pytest
import torch

from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.checkpoint import CheckpointManager
from tests import torch_ranks
from tests.test_torch_engine_loop import _straddling
from tests.test_torch_train import ZERO_GRADIENT_SHARE, _is_zero_gradient_leaf

RTOL = 1e-5  # losses and grad norms
# Each step-1 gradient, of its leaf's largest |value|. Both sides' fp32
# gradients lie that far from the step's float64 gradient (on the one
# process's global batch and mask): the one process's up to 4.6e-5 of the
# leaf, dp4's up to 7.4e-5, and the two up to 9.0e-5 apart (dp4,
# enc3_vim.width_block.vit_mamba.mixer.BCdt_proj): BatchNorm's
# E[x^2] - E[x]^2 over rank means cancels differently. A sharding fault
# (a missing average, a rank's own statistics or mask) moves them by O(1).
GRAD_RTOL = 2e-4
# Plus this share of the largest gradient of all: the leaves left by
# cancelling sums (below 1e-3 of the largest) differ by up to 4.4e-8 of it.
NOISE_SHARE = 1e-7
STATS_ATOL = 1e-6
STATE_ATOL = 1e-6  # of the leaf's largest |value|, past the gradients' share
LOSS_RTOL = 1e-4  # the loop's losses and scores: the train step's bound
STRADDLE_SHARE = 1e-3
CASES = {"dp2": (2, 1, False), "model2_fsdp": (1, 2, True), "dp4": (4, 1, False),
         "dp2_model2_fsdp": (2, 2, True)}
WORLDS = {2: ("dp2", "model2_fsdp"), 4: ("dp4", "dp2_model2_fsdp")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one process's steps and loops, and every case's ranks."""
    tmp = tmp_path_factory.mktemp("dp")
    ref_dir = str(tmp / "ref")
    ref = torch_ranks.run_steps(torch_ranks.small_config(), ref_dir, write=True)
    loops = {cache: torch_ranks.trainer_job(str(tmp / f"one{int(cache)}"), cache)
             for cache in (False, True)}
    ranks = {}
    for world, names in WORLDS.items():
        jobs = [(torch_ranks.step_job, (*CASES[n], ref_dir, str(tmp / f"fsdp_{n}")))
                for n in names]
        if world == 2:
            jobs += [(torch_ranks.trainer_job, (str(tmp / f"dp{int(c)}"), c))
                     for c in (False, True)]
        got = torch_ranks.spawn(torch_ranks.run_jobs, world, tmp, jobs, timeout=300)
        for i, name in enumerate(names):
            ranks[name] = [r[i] for r in got]
        if world == 2:
            for i, cache in enumerate((False, True), start=len(names)):
                ranks[("loop", cache)] = [r[i] for r in got]
    return {"tmp": tmp, "ref": ref, "loops": loops, "ranks": ranks}


def _block(whole, rank, key):
    """The one process's tensor cut as ``rank`` holds it."""
    dim = rank["shards"].get(key)
    if dim is None:
        return whole
    return whole.chunk(rank["shape"]["model"], dim=dim)[rank["coords"]["model"]]


def _max(t) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grad_norms_match_one_process(runs, case):
    ref = runs["ref"]["steps"]
    for rank in runs["ranks"][case]:
        for i, (got, want) in enumerate(zip(rank["steps"], ref)):
            for key in ("loss", "grad_norm"):
                assert math.isclose(got[key], want[key], rel_tol=RTOL), (i, key, got[key],
                                                                         want[key])


@pytest.mark.parametrize("case", list(CASES))
def test_step1_gradients_match_one_process(runs, case):
    want = runs["ref"]["steps"][0]["grads"]
    largest = max(_max(g) for g in want.values())
    for rank in runs["ranks"][case]:
        got = rank["steps"][0]["grads"]
        assert set(got) == set(want)
        for key, g in got.items():
            w = _block(want[key], rank, key)
            assert g.shape == w.shape, key
            if _is_zero_gradient_leaf(key):
                assert max(_max(g), _max(w)) <= ZERO_GRADIENT_SHARE * largest, key
            else:
                assert _max(g - w) <= GRAD_RTOL * _max(want[key]) + NOISE_SHARE * largest, (
                    key, _max(g - w), _max(want[key]))


@pytest.mark.parametrize("case", list(CASES))
def test_batch_norm_buffers_match_one_process(runs, case):
    ranks = runs["ranks"][case]
    for i, want in enumerate(s["stats"] for s in runs["ref"]["steps"]):
        first = ranks[0]["steps"][i]["stats"]
        for rank in ranks:
            for key, b in rank["steps"][i]["stats"].items():
                assert torch.equal(b, first[key]), (i, key)  # every rank's alike
                assert _max(b - want[key]) <= STATS_ATOL * max(1.0, _max(want[key])), (i, key)


def _adam_update(g, mu, nu, count):
    """AdamW's update direction for the gradient g from the moments after
    ``count`` updates (tests/test_torch_train.py's)."""
    t = count + 1
    g = g.double()
    mu_hat = (0.9 * mu.double() + 0.1 * g) / (1 - 0.9 ** t)
    nu_hat = (0.999 * nu.double() + 0.001 * g * g) / (1 - 0.999 ** t)
    return mu_hat / (nu_hat.sqrt() + 1e-8)


@pytest.mark.parametrize("case", list(CASES))
def test_state_after_each_step_matches_one_process(runs, case):
    """Each parameter after each step within STATE_ATOL of the leaf's largest
    |value| plus lr times the difference of AdamW's update for the two
    gradients, from the moments before the step (zero before step 1, the
    one process's checkpoint before step 2)."""
    cfg = torch_ranks.small_config()
    ref = runs["ref"]["steps"]
    saved = CheckpointManager(str(runs["tmp"] / "ref")).restore(1)["opt_state"]
    names = list(ref[0]["params"])
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    for i in range(2):
        lr = tx.lr(i)
        for rank in runs["ranks"][case]:
            got = rank["steps"][i]
            for j, key in enumerate(names):
                want = ref[i]["params"][key]
                if i == 0:
                    mu = nu = torch.zeros_like(got["grads"][key])
                else:
                    mu, nu = (_block(saved[m][j], rank, key) for m in ("mu", "nu"))
                slack = lr * (_adam_update(got["grads"][key], mu, nu, i)
                              - _adam_update(_block(ref[i]["grads"][key], rank, key), mu, nu,
                                             i)).abs()
                err = (got["params"][key] - _block(want, rank, key)).abs().double() - slack
                assert _max(err.clamp_min(0)) <= STATE_ATOL * _max(want), (i, key)


def test_fsdp_checkpoints_restore_across_meshes(runs):
    """The one process's checkpoint restored into a model2 FSDP state gives
    each rank its blocks; that state saved by the FSDP ranks (the leaves
    gathered whole) restores in one process to the same tensors."""
    saved = CheckpointManager(str(runs["tmp"] / "ref")).restore(1)
    for name in ("model2_fsdp", "dp2_model2_fsdp"):
        for rank in runs["ranks"][name]:
            assert rank["shards"], name
            for key, p in rank["restored"].items():
                assert torch.equal(p, _block(saved["params"][key], rank, key)), key
        again = CheckpointManager(str(runs["tmp"] / f"fsdp_{name}")).restore(1)
        for key, p in saved["params"].items():
            assert torch.equal(again["params"][key], p), key
        for m in ("mu", "nu"):
            for a, b in zip(again["opt_state"][m], saved["opt_state"][m]):
                assert torch.equal(a, b)


def _scored(ranks):
    """The (target, prediction) of each test batch, the ranks' rows joined."""
    per_rank = [r["scored"] for r in ranks]
    return [tuple(torch.cat([rows[b][k] for rows in per_rank]).numpy() for k in (0, 1))
            for b in range(len(per_rank[0]))]


@pytest.mark.parametrize("cache", [False, True], ids=["loader", "device_cache"])
def test_loop_dp2_matches_one_process(runs, cache):
    """The dp2 loop's history and test scores within the step's bound of the
    one process's, the same on both ranks; the counts within the pixels that
    straddle a threshold between the two predictions."""
    ranks = runs["ranks"][("loop", cache)]
    one = runs["loops"][cache]
    want = one["results"]
    for rank in ranks:
        got = rank["results"]
        assert got["steps"] == want["steps"] == 2
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][key], want["history"][key],
                                       rtol=LOSS_RTOL, err_msg=key)
        for key in ("test_loss", "RMSE", "SSIM", "FAR"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
        assert got["threshold_metrics"].keys() == want["threshold_metrics"].keys()
    np.testing.assert_equal(ranks[0]["results"], ranks[1]["results"])
    thresholds = tuple(torch_ranks.small_config().data.thresholds)
    for (tgt, pred), (tgt1, pred1) in zip(_scored(ranks), _scored([one])):
        np.testing.assert_array_equal(tgt, tgt1)
        np.testing.assert_allclose(pred, pred1, rtol=0, atol=1e-4)
        straddle = _straddling(pred, pred1, thresholds, 90.0)
        assert (straddle <= STRADDLE_SHARE * pred.size).all(), straddle


def test_dp2_checkpoint_scores_in_one_process(runs):
    """The dp2 loop's best checkpoint (written by rank 0, the whole state)
    scored by ``evaluate_checkpoint`` in one process: the loop's own test
    pass within the step's bound."""
    tmp = runs["tmp"] / "dp0"
    cfg = torch_ranks.trainer_config(tmp, False)
    cfg.mesh.data = 1
    got = engine.evaluate_checkpoint(cfg, cfg.train.ckpt_dir, which="best", device="cpu")
    want = runs["ranks"][("loop", False)][0]["results"]
    assert got["checkpoint_step"] == 2
    for key in ("test_loss", "RMSE", "SSIM", "FAR"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
