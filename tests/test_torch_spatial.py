"""KM_UNetV3 with its image rows sharded over the mesh's 'spatial' axis
(``parallel/halo.py``), on gloo ranks on the CPU, against one process.

Per module, at spatial 2 and 4 (``torch_rows.module_job``): the halo conv
(3x3, and 7x7 whose halo spans several ranks' rows at sp4), ``halo_rows``
with zeros, wrap and replicate, the DWT with the reference's zeroed last
row (IWP), GroupNorm (with the KAN conv), BatchNorm over data x spatial,
the HSM-SSD block, the EnhancedViM block, LCA, MultiScaleFusion,
``resize_bilinear`` down and up, DySample's window and exact paths, DAGEM
and the deformable conv (offsets reaching across row blocks) on the plain
gathers: the output rows and the input's gradient rows within 1e-5 of the
largest |value|, each parameter's gradient summed over the ranks within
1e-5 of its largest |value| (of 1e-6 of the module's largest gradient for
the leaves whose exact gradient is 0), the BatchNorm buffers within 1e-5;
in fp32, or in float64 where the module's train-mode BatchNorm cancels in
fp32 (``torch_rows.MODULES``).

The whole step at tests/test_sharding_parity.py's config (32^2, B=8, 9 ->
4 frames, fp32, drop path 0.1) under dp1 x sp2, dp2 x sp2 and dp1 x sp4,
the LAPS variant's under sp2, and the SH step with the KAN regularizer on
(whose gradient every spatial rank holds whole) under dp1 x sp2 and
dp2 x sp2, two steps each, by
tests/test_torch_data_parallel.py's rules: losses and grad norms, the
step-1 gradients leaf by leaf, the BatchNorm buffers, the state after each
step. Then the loop under sp2 against one process (the loader and the
device-cache epoch), its checkpoint scored in one process, and the
refusals. One spawn per world size.
"""

import math

import numpy as np
import pytest
import torch

from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.checkpoint import CheckpointManager
from tests import torch_ranks, torch_rows
from tests.test_torch_data_parallel import (GRAD_RTOL, LOSS_RTOL, NOISE_SHARE, RTOL,
                                            STATE_ATOL, STATS_ATOL, _adam_update)
from tests.test_torch_train import ZERO_GRADIENT_SHARE, _is_zero_gradient_leaf

MODULE_RTOL = 1e-5
ZERO_LEAF_SHARE = 1e-6  # of the module's largest gradient: a leaf whose exact gradient is 0
STEPS = {"dp1_sp2": (1, 2, "sh"), "laps_sp2": (1, 2, "laps"), "dp2_sp2": (2, 2, "sh"),
         "dp1_sp4": (1, 4, "sh"), "kan_reg_dp1_sp2": (1, 2, "kan_reg"),
         "kan_reg_dp2_sp2": (2, 2, "kan_reg")}
WORLDS = {2: ("dp1_sp2", "laps_sp2", "kan_reg_dp1_sp2"),
          4: ("dp2_sp2", "dp1_sp4", "kan_reg_dp2_sp2")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one process's steps (each variant of ``STEPS``) and loop, and
    every world's ranks."""
    tmp = tmp_path_factory.mktemp("sp")
    refs = {v: str(tmp / f"ref_{v}") for v in {v for _, _, v in STEPS.values()}}
    ref = {v: torch_ranks.run_steps(torch_rows.step_config(v), path, write=True)
           for v, path in refs.items()}
    loops = {cache: torch_ranks.trainer_job(str(tmp / f"one{int(cache)}"), cache)
             for cache in (False, True)}
    ranks = {}
    for world, names in WORLDS.items():
        jobs = [(torch_rows.module_job, ((1, world, 1),))]
        jobs += [(torch_rows.step_job, (*STEPS[n][:2], refs[STEPS[n][2]], STEPS[n][2]))
                 for n in names]
        if world == 2:
            jobs += [(torch_rows.trainer_job, (str(tmp / f"sp2_{int(c)}"), 2, c))
                     for c in (False, True)]
            jobs += [(torch_rows.refusals_job, (str(tmp / "refused"),))]
        got = torch_ranks.spawn(torch_ranks.run_jobs, world, tmp, jobs, timeout=300)
        ranks[("modules", world)] = [r[0] for r in got]
        for i, name in enumerate(names, start=1):
            ranks[name] = [r[i] for r in got]
        if world == 2:
            for i, cache in enumerate((False, True), start=len(names) + 1):
                ranks[("loop", cache)] = [r[i] for r in got]
            ranks["refusals"] = [r[len(names) + 3] for r in got]
    return {"tmp": tmp, "ref": ref, "loops": loops, "ranks": ranks}


def _max(t) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(torch_rows.MODULES))
def test_module_on_sharded_rows_matches_whole(runs, world, name):
    for rank in runs["ranks"][("modules", world)]:
        case = rank[name]
        for key in ("out", "dx"):
            got, want = case[key]
            assert got.shape == want.shape, (key, got.shape, want.shape)
            assert _max(got - want) <= MODULE_RTOL * _max(want), (key, _max(got - want),
                                                                  _max(want))
        largest = max(_max(w) for _, w in case["params"])
        for i, (got, want) in enumerate(case["params"]):
            scale = max(_max(want), ZERO_LEAF_SHARE * largest)
            assert _max(got - want) <= MODULE_RTOL * scale, (i, _max(got - want), _max(want))
        for got, want in case["buffers"]:
            assert _max(got - want) <= MODULE_RTOL * max(_max(want), 1.0)


def _ref(runs, case):
    return runs["ref"][STEPS[case][2]]


@pytest.mark.parametrize("case", list(STEPS))
def test_losses_and_grad_norms_match_one_process(runs, case):
    ref = _ref(runs, case)["steps"]
    for rank in runs["ranks"][case]:
        for i, (got, want) in enumerate(zip(rank["steps"], ref)):
            for key in ("loss", "grad_norm"):
                assert math.isclose(got[key], want[key], rel_tol=RTOL), (i, key, got[key],
                                                                         want[key])


@pytest.mark.parametrize("case", list(STEPS))
def test_step1_gradients_match_one_process(runs, case):
    """tests/test_torch_data_parallel.py's rule: no leaf off by the shard
    count, or by any sharding fault."""
    want = _ref(runs, case)["steps"][0]["grads"]
    largest = max(_max(g) for g in want.values())
    for rank in runs["ranks"][case]:
        got = rank["steps"][0]["grads"]
        assert set(got) == set(want)
        for key, g in got.items():
            w = want[key]
            assert g.shape == w.shape, key
            if _is_zero_gradient_leaf(key):
                assert max(_max(g), _max(w)) <= ZERO_GRADIENT_SHARE * largest, key
            else:
                assert _max(g - w) <= GRAD_RTOL * _max(w) + NOISE_SHARE * largest, (
                    key, _max(g - w), _max(w))


@pytest.mark.parametrize("case", list(STEPS))
def test_batch_norm_buffers_match_one_process(runs, case):
    ranks = runs["ranks"][case]
    for i, want in enumerate(s["stats"] for s in _ref(runs, case)["steps"]):
        first = ranks[0]["steps"][i]["stats"]
        for rank in ranks:
            for key, b in rank["steps"][i]["stats"].items():
                assert torch.equal(b, first[key]), (i, key)  # every rank's alike
                assert _max(b - want[key]) <= STATS_ATOL * max(1.0, _max(want[key])), (i, key)


@pytest.mark.parametrize("case", list(STEPS))
def test_state_after_each_step_matches_one_process(runs, case):
    """Each parameter after each step within STATE_ATOL of the leaf's largest
    |value| plus lr times the difference of AdamW's update for the two
    gradients (tests/test_torch_data_parallel.py's rule); every rank's
    parameters alike."""
    variant = STEPS[case][2]
    cfg = torch_rows.step_config(variant)
    ref = _ref(runs, case)["steps"]
    saved = CheckpointManager(str(runs["tmp"] / f"ref_{variant}")).restore(1)
    names = list(ref[0]["params"])
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    ranks = runs["ranks"][case]
    for i in range(2):
        lr = tx.lr(i)
        for rank in ranks:
            got = rank["steps"][i]
            for j, key in enumerate(names):
                assert torch.equal(got["params"][key], ranks[0]["steps"][i]["params"][key])
                want = ref[i]["params"][key]
                if i == 0:
                    mu = nu = torch.zeros_like(got["grads"][key])
                else:
                    mu, nu = saved["opt_state"]["mu"][j], saved["opt_state"]["nu"][j]
                slack = lr * (_adam_update(got["grads"][key], mu, nu, i)
                              - _adam_update(ref[i]["grads"][key], mu, nu, i)).abs()
                err = (got["params"][key] - want).abs().double() - slack
                assert _max(err.clamp_min(0)) <= STATE_ATOL * _max(want), (i, key)


@pytest.mark.parametrize("cache", [False, True], ids=["loader", "device_cache"])
def test_loop_sp2_matches_one_process(runs, cache):
    """``train_and_evaluate`` under sp2 (the loader, or the device-cache
    epoch, hands each rank its rows): the history and test scores within the
    step's bound of one process's, the same on both ranks, each scoring the
    whole frames."""
    ranks, one = runs["ranks"][("loop", cache)], runs["loops"][cache]
    want = one["results"]
    for rank in ranks:
        got = rank["results"]
        assert got["steps"] == want["steps"] == 2
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][key], want["history"][key],
                                       rtol=LOSS_RTOL, err_msg=key)
        for key in ("test_loss", "RMSE", "SSIM", "FAR"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
        for (tgt, pred), (tgt1, pred1) in zip(rank["scored"], one["scored"]):
            assert tgt.shape == tgt1.shape and torch.equal(tgt, tgt1)
            np.testing.assert_allclose(pred.numpy(), pred1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_equal(ranks[0]["results"], ranks[1]["results"])


def test_sp2_checkpoint_scores_in_one_process(runs):
    """The sp2 loop's best checkpoint (rank 0's, the whole state) scored by
    ``evaluate_checkpoint`` in one process: the loop's own test pass."""
    cfg = torch_ranks.trainer_config(runs["tmp"] / "sp2_0", False)
    got = engine.evaluate_checkpoint(cfg, cfg.train.ckpt_dir, which="best", device="cpu")
    want = runs["ranks"][("loop", False)][0]["results"]
    assert got["checkpoint_step"] == 2
    for key in ("test_loss", "RMSE", "SSIM", "FAR"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("case, error, match", [
    ("spatial_x_model", "ValueError", "combining spatial>1 with model>1"),
    ("other_model", "NotImplementedError", "smaat_unet on sharded image rows is ROADMAP "
                                           "Queue 1 item 12"),
    ("kan_fused", "NotImplementedError", r"fused KAN conv \(K1\) on sharded rows is ROADMAP "
                                         "Queue 1 item 12"),
    ("ssd_mixer", "NotImplementedError", r"mixer='fused' \(K2/K3\) on sharded rows is ROADMAP "
                                         "Queue 1 item 12"),
    ("uneven_rows", "ValueError", "img_size 40 is not divisible by 8 x spatial=2"),
    ("k1_forward", "NotImplementedError", "K1.* item 12"),
])
def test_what_sharded_rows_refuse(runs, case, error, match):
    import re

    for rank in runs["ranks"]["refusals"]:
        got = rank[case]
        assert got is not None and got[0] == error and re.search(match, got[1]), got
