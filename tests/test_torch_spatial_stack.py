"""ConvLSTM, TrajGRU and Mamba-UNet with their image rows sharded over the
mesh's 'spatial' axis (``parallel/halo.py``), on gloo ranks on the CPU,
against one process and against the JAX package.

The halos these models add (``torch_stack_rows.HALOS``), at spatial 2 and
4: EF's strided stages (k6 s4, k4 s4, k3 s2) and a k7 s2 conv whose halo
is taller than a rank's rows, the transposed stages (k4 s2, k6 s4) and
Mamba-UNet's 2x2 up, a dilated 7x7 and Mamba-UNet's spatial bridge whose
9-row halo spans every rank at one row a rank, Mamba's causal token halo
(3 tokens over 2 a rank), the whole ``MambaBlock`` on a rank's tokens (its
chunk scan; ``A_log`` and ``D`` summed over the ranks once), TrajGRU's warp
with its coordinates built in fp32 and in bf16 from the global row index:
the output rows and the input's gradient rows within 1e-5 of the largest
|value|, each parameter's gradient summed over the ranks within 1e-5 of
its largest |value| (tests/test_torch_spatial.py's rule).

Each model's eval forward under dp1 x sp2 at 64^2, fp32, on the JAX
model's converted perturbed weights (TrajGRU's flows a few pixels long):
the gathered rows within 1e-4 abs of JAX's forward (BASELINE.json's
per-layer bound). Each model's ("pic") recipe step under dp1 x sp2 and
dp2 x sp2 at 64^2 (B=2) and dp1 x sp4 at 128^2 (B=1), 3 -> 2 frames,
fp32, against one process by tests/test_torch_data_parallel.py's gates:
the loss and grad norm, the gradients leaf by leaf, the state after the
step within what the optimizer makes of the two gradients (reckoned in
the ranks: the EF models' leaves are 12M values). TrajGRU's loop under
sp2 for one epoch against one process's. ``build_mesh``'s and the models'
refusals; ``set_data_axis`` on the models without BatchNorm. One spawn
per world size.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.models.ef as ef_jax
import kmunet_tpu.models.mamba_unet as mamba_unet_jax
from kmunet_tpu_torch.models import ef, lptqpn, mamba_unet
from kmunet_tpu_torch.nn.layers import set_data_axis
from kmunet_tpu_torch.parallel.mesh import Axis
from tests import torch_ranks, torch_stack_rows
from tests.test_torch_data_parallel import GRAD_RTOL, LOSS_RTOL, NOISE_SHARE, RTOL, STATE_ATOL
from tests.torch_parity import init_perturbed, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODULE_RTOL = 1e-5
ZERO_LEAF_SHARE = 1e-6  # of the module's largest gradient: a leaf whose exact gradient is 0
FORWARD_ATOL = 1e-4
FORWARD_FLOW_SCALE = 5.0  # the perturbed TrajGRU's flows, times this: a few pixels
MODELS = torch_stack_rows.MODELS
STEPS = {"dp1_sp2": (1, 2, 64), "dp2_sp2": (2, 2, 64), "dp1_sp4": (1, 4, 128)}
CASES = [(case, name) for case in STEPS for name in MODELS]


def _max(t) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def _jax_forward(name, tmp):
    """JAX's eval forward of ``name`` at 64^2, B=2, 3 -> 2 frames on
    perturbed weights (TrajGRU's flow convs scaled by FORWARD_FLOW_SCALE),
    and the port's state_dict of the same weights, saved under ``tmp``:
    (state path, input, output)."""
    rng = np.random.default_rng(31)
    if name == "mamba_unet":
        x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
        jm, tm = (mamba_unet_jax.Mamba_UNet(predicted_frames=2),
                  mamba_unet.Mamba_UNet(predicted_frames=2, input_frames=3))
    else:
        x = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
        jm, tm = ((ef_jax.ConvLSTM_EF(out_frames=2), ef.ConvLSTM_EF(out_frames=2))
                  if name == "convlstm" else
                  (ef_jax.TrajGRU_EF(out_frames=2), ef.TrajGRU_EF(out_frames=2)))
    variables = init_perturbed(jm, jnp.asarray(x), seed=32)
    if name == "trajgru":
        for rnn in ("enc_rnn1", "enc_rnn2", "enc_rnn3", "fore_rnn3", "fore_rnn2", "fore_rnn1"):
            flows = variables["params"][rnn]["flows_conv"]
            for k in flows:
                flows[k] = flows[k] * FORWARD_FLOW_SCALE
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    path = tmp / f"{name}.pt"
    torch.save(port(tm, variables).state_dict(), path)
    return str(path), x, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's forwards; the one process's step (each model at 64^2 and
    128^2, saved for the ranks) and TrajGRU's loop; every world's ranks."""
    tmp = tmp_path_factory.mktemp("sp_stack")
    forwards = {name: _jax_forward(name, tmp) for name in MODELS}
    ref, ref_path = {}, {}
    for name in MODELS:
        for size in (64, 128):
            one = torch_stack_rows.one_step(torch_stack_rows.stack_config(name, size))
            ref_path[(name, size)] = str(tmp / f"ref_{name}_{size}.pt")
            torch.save(one, ref_path[(name, size)])
            ref[(name, size)] = {"loss": one["loss"], "grad_norm": one["grad_norm"]}
    original = torch_ranks.trainer_config
    torch_ranks.trainer_config = lambda t, cache: torch_stack_rows.trainer_config(t, 1)
    try:
        loop = torch_ranks.trainer_job(str(tmp / "loop_one"), False)
    finally:
        torch_ranks.trainer_config = original
    ranks = {}
    for world in (2, 4):
        jobs = [(torch_stack_rows.halo_job, ((1, world, 1),))]
        keys = [("halos", world)]
        for case, (d, sp, size) in STEPS.items():
            if d * sp == world:
                jobs += [(torch_stack_rows.step_job, (name, size, d, sp, ref_path[(name, size)]))
                         for name in MODELS]
                keys += [(case, name) for name in MODELS]
        if world == 2:
            jobs += [(torch_stack_rows.forward_job, (name, *forwards[name][:2]))
                     for name in MODELS]
            keys += [("forward", name) for name in MODELS]
            jobs += [(torch_stack_rows.trainer_job, (str(tmp / "loop_sp2"), 2)),
                     (torch_stack_rows.refusals_job, ())]
            keys += ["loop", "refusals"]
        got = torch_ranks.spawn(torch_ranks.run_jobs, world, tmp, jobs, timeout=400)
        for i, key in enumerate(keys):
            ranks[key] = [r[i] for r in got]
    for path in [*ref_path.values(), *(f[0] for f in forwards.values())]:
        os.remove(path)  # the EF models' are 50-100 MB each
    return {"forwards": forwards, "ref": ref, "loop": loop, "ranks": ranks}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(torch_stack_rows.HALOS))
def test_halo_on_sharded_rows_matches_whole(runs, world, name):
    for rank in runs["ranks"][("halos", world)]:
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


@pytest.mark.parametrize("name", MODELS)
def test_forward_on_sharded_rows_matches_jax(runs, name):
    """dp1 x sp2: the two ranks' output rows, put together, against JAX's
    forward of the whole image on the same weights and input."""
    _, x, want = runs["forwards"][name]
    rows = runs["ranks"][("forward", name)]
    dim = 2 if name in torch_stack_rows.EF_MODELS else 1
    assert all(r.shape[dim] == want.shape[dim] // 2 for r in rows)
    got = torch.cat(rows, dim).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 10 * FORWARD_ATOL  # the gate is not vacuous
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)


@pytest.mark.parametrize("case, name", CASES)
def test_loss_and_grad_norm_match_one_process(runs, case, name):
    want = runs["ref"][(name, STEPS[case][2])]
    for rank in runs["ranks"][(case, name)]:
        for key in ("loss", "grad_norm"):
            assert math.isclose(rank[key], want[key], rel_tol=RTOL), (key, rank[key], want[key])


@pytest.mark.parametrize("case, name", CASES)
def test_gradients_match_one_process(runs, case, name):
    """The step's gradients leaf by leaf (tests/test_torch_data_parallel.py's
    rule): no leaf off by the shard count (the scan's A_log and D, which
    enter every rank's chunk), or by any sharding fault."""
    for rank in runs["ranks"][(case, name)]:
        assert rank["same_leaves"]
        largest = max(leaf["grad_max"] for leaf in rank["leaves"].values())
        for key, leaf in rank["leaves"].items():
            assert leaf["grad_err"] <= GRAD_RTOL * leaf["grad_max"] + NOISE_SHARE * largest, (
                key, leaf)


@pytest.mark.parametrize("case, name", CASES)
def test_state_after_the_step_matches_one_process(runs, case, name):
    """Each parameter after the step within STATE_ATOL of the leaf's largest
    |value| past what the recipe's optimizer (Adam for the EF models, SGD
    with momentum for Mamba-UNet) makes of the two gradients from the same
    weights; every rank's parameters alike."""
    for rank in runs["ranks"][(case, name)]:
        assert rank["alike"]
        for key, leaf in rank["leaves"].items():
            assert leaf["state_err"] <= STATE_ATOL * leaf["param_max"], (key, leaf)


def test_trajgru_loop_sp2_matches_one_process(runs):
    """``train_and_evaluate`` of TrajGRU under sp2 (the loader hands each
    rank its rows): the history and test scores within the step's bound of
    one process's, the same on both ranks, each scoring the whole frames."""
    ranks, one = runs["ranks"]["loop"], runs["loop"]
    want = one["results"]
    for rank in ranks:
        got = rank["results"]
        assert got["steps"] == want["steps"] == 2
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][key], want["history"][key],
                                       rtol=LOSS_RTOL, err_msg=key)
        for key in ("test_loss", "RMSE", "SSIM", "FAR"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
        assert len(rank["scored"]) == len(one["scored"]) > 0
        for (tgt, pred), (tgt1, pred1) in zip(rank["scored"], one["scored"]):
            assert tgt.shape == tgt1.shape == (2, 2, 64, 64) and torch.equal(tgt, tgt1)
            np.testing.assert_allclose(pred.numpy(), pred1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_equal(ranks[0]["results"], ranks[1]["results"])


REFUSALS = [(f"accepted_{name}", None, None) for name in MODELS]
REFUSALS += [(f"uneven_{name}", "ValueError",
              f"img_size 96 is not divisible by 32 x spatial=2 for {name}") for name in MODELS]
REFUSALS += [("seq_mesh", "ValueError", "seq_mesh cuts L over the mesh, and sharded image rows"),
             ("baseline", "NotImplementedError", "SmaAt_UNet on sharded image rows is ROADMAP "
                                                 "Queue 1 item 12")]


@pytest.mark.parametrize("case, error, match", REFUSALS)
def test_what_sharded_rows_accept_and_refuse(runs, case, error, match):
    for rank in runs["ranks"]["refusals"]:
        got = rank[case]
        if error is None:
            assert got is None, got
        else:
            assert got is not None and got[0] == error and re.search(match, got[1]), got


@pytest.mark.parametrize("make", [
    lambda: mamba_unet.Mamba_UNet(predicted_frames=2, input_frames=3),
    lambda: lptqpn.LPTQPN(out_frames=2)], ids=["mamba_unet", "lptqpn"])
def test_set_data_axis_is_a_no_op_without_batch_norm(make):
    """Mamba-UNet and LPTQPN have no BatchNorm and no DropPath: the data
    axes change nothing on them, and raise nothing."""
    model = make()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    axis = Axis("data", 2, 1)
    assert set_data_axis(model, axis, Axis(("data", "spatial"), 4, 2)) is model
    assert not any(hasattr(m, "data_axis") for m in model.modules())
    after = model.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], before[k]) for k in before)
