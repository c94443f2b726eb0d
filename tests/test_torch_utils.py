"""The port's ``utils/`` and ``__version__`` against the JAX package's.

FLOP counts: ``flops_of`` and ``lowered_flops`` give a matmul's 2n^3 and a
conv's in-bounds taps (tests/test_flops.py's hand formula); the kernels'
wrappers record what the JAX wrappers record for the same shapes (JAX
traced under ``jax.eval_shape`` with the Pallas paths forced, as the TPU
takes them): K5 at test_flops.py's shape, SH at 32^2 on the window path (K7
at the bridge) and the exact path (K7 and three K4), TrajGRU (K7 per cell
step: JAX's ``lax.scan`` traces each layer's step twice, the port records
every step) and Mamba-UNet at 128^2 (K8 per scan; JAX's Pallas scan takes
no smaller input); the plain scan's own products are not counted on top.
Then the NaN hooks name the module, ``guard`` and ``assert_finite`` raise,
``CSVLogger``, ``set_seed``, ``trace`` and ``vis_channels`` write what
they should.
"""

import csv
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import kmunet_tpu
import kmunet_tpu.nn.resample as resample_jax
from kmunet_tpu.kernels.bilinear_pallas import gather_bilinear_border
from kmunet_tpu.models import ef as ef_jax
from kmunet_tpu.models import mamba_unet as mamba_unet_jax
from kmunet_tpu.models.km_unet import KM_UNetV3_SH as KM_UNetV3_SH_jax
from kmunet_tpu.ops import sample as sample_jax
from kmunet_tpu.ops import scan as scan_jax
from kmunet_tpu.utils.flops import tally_custom_flops as tally_jax
import kmunet_tpu_torch
from kmunet_tpu_torch import serve, utils
from kmunet_tpu_torch.kernels import bilinear, scan
from kmunet_tpu_torch.utils import vis
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def test_version_is_the_jax_packages():
    assert kmunet_tpu_torch.__version__ == kmunet_tpu.__version__ == "0.1.0"


def test_matmul_counts_2n3():
    n = 48
    a = torch.rand(n, n)
    for count in (utils.flops_of, utils.lowered_flops):
        got = count(torch.matmul, a, a)
        assert got == {"flops": 2.0 * n ** 3, "bytes_accessed": -1.0, "custom_flops": 0.0}


def test_conv_counts_in_bounds_taps():
    """tests/test_flops.py:39: B2, 16x16x8 -> k3 s1 p1, 32 channels."""
    B, H, Cin, Cout, k = 2, 16, 8, 32, 3
    taps = sum(1 for o in range(H) for j in range(k) if 0 <= o - 1 + j < H)
    x, w = torch.zeros(B, Cin, H, H), torch.zeros(Cout, Cin, k, k)
    for count in (utils.flops_of, utils.lowered_flops):
        got = count(lambda x, w: F.conv2d(x, w, padding=1), x, w)["flops"]
        assert got == 2 * B * taps * taps * Cin * Cout


def _jax_records(model, x, window=True):
    """The custom FLOPs the JAX wrappers record in one forward of ``model``,
    the Pallas paths forced (as the TPU takes them)."""
    patches = [(sample_jax, "USE_PALLAS_GATHER", True), (scan_jax, "USE_PALLAS_SCAN", True),
               (resample_jax, "DYSAMPLE_WINDOW", window)]
    saved = [getattr(m, a) for m, a, _ in patches]
    for m, a, v in patches:
        setattr(m, a, v)
    try:
        variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
        with tally_jax() as t:
            jax.eval_shape(model.apply, variables, x)
    finally:
        for (m, a, _), v in zip(patches, saved):
            setattr(m, a, v)
    return list(t._records)


def _port_records(model, x):
    """What the port's wrappers record in one forward of ``model``, which
    ``lowered_flops`` (on meta copies) sums as the CPU forward does."""
    with torch.no_grad(), utils.tally_custom_flops() as t:
        model(x)
    assert utils.lowered_flops(lambda m, x: m(x), model, x)["custom_flops"] == t.total
    return t.records


def test_k5_records_the_jax_figure():
    B, H, W, C, Ho, Wo = 1, 16, 16, 8, 8, 8
    with tally_jax() as t:
        jax.eval_shape(lambda i, xx, yy: gather_bilinear_border(i, xx, yy, True),
                       jnp.zeros((B, H, W, C), jnp.bfloat16), jnp.zeros((B, Ho, Wo)),
                       jnp.zeros((B, Ho, Wo)))
    img, xs = torch.zeros(B, H, W, C), torch.zeros(B, Ho, Wo)
    got = utils.flops_of(bilinear.bilinear_gather, img, xs, xs)
    assert got["custom_flops"] == t.total == 8.0 * B * Ho * Wo * C
    assert got["flops"] == 0.0


@pytest.mark.parametrize("window", [True, False], ids=["window", "exact"])
def test_sh_records_the_jax_figures(window):
    want = _jax_records(KM_UNetV3_SH_jax(num_classes=4), jnp.zeros((2, 32, 32, 5)), window)
    model = serve.build_km_unet_v3_sh(device="cpu", dysample_window=window)
    got = _port_records(model, torch.zeros(2, 32, 32, 5))
    # JAX's deformable conv records its 9 taps as 9 single gathers, the
    # port's one K7 launch the 9 views at once: the same sum.
    assert sum(got) == sum(want)
    assert len(got) == (1 if window else 4) and len(want) == (9 if window else 12)


def test_trajgru_records_the_jax_figures():
    out_frames = 3
    want = _jax_records(ef_jax.TrajGRU_EF(out_frames=out_frames), jnp.zeros((1, 5, 64, 64)))
    model = serve.build_zoo_model("trajgru", device="cpu", out_frames=out_frames, img_size=64)
    got = _port_records(model, torch.zeros(1, 5, 64, 64))
    # JAX's lax.scan traces each layer's step twice, however many steps it
    # runs; the port records each step: 5 input frames through the three
    # encoder layers, out_frames through the three forecaster layers.
    per_layer = want[::2]
    assert want == [v for v in per_layer for _ in range(2)] and len(per_layer) == 6
    assert got == [v for i, v in enumerate(per_layer) for _ in range(5 if i < 3 else out_frames)]


def test_mamba_unet_records_the_jax_figures(monkeypatch):
    want = _jax_records(mamba_unet_jax.Mamba_UNet(predicted_frames=4), jnp.zeros((1, 128, 128, 5)))
    model = serve.build_zoo_model("mamba_unet", device="cpu", out_frames=4, img_size=128)
    # The count reads shapes only: the plain scan's token loop (minutes at
    # L = 16384, meta tensors or not) gives way to its output's shape.
    monkeypatch.setattr(scan.SelectiveScan, "apply", staticmethod(lambda x, *a: x.clone()))
    got = _port_records(model, torch.zeros(1, 128, 128, 5))
    assert len(got) == len(want) == 20
    assert got == want


def test_plain_scan_products_are_not_counted_twice():
    """The plain scan runs an einsum per chunk (a bmm the counter sees): the
    count holds K8's recorded figure alone."""
    Bs, L, D, N = 2, 80, 4, 3
    x = torch.rand(Bs, L, D)
    args = (x, torch.rand(Bs, L, D), -torch.rand(D, N), torch.rand(Bs, L, N),
            torch.rand(Bs, L, N), torch.rand(D))
    got = utils.flops_of(scan.selective_scan, *args)
    assert got["flops"] == 0.0
    assert got["custom_flops"] == 8.0 * Bs * L * D * N + 2.0 * Bs * L * D
    with utils.tally_custom_flops() as outer:
        with utils.tally_custom_flops() as inner:
            scan.selective_scan(*args)
        assert inner.total > 0
    assert outer.total == 0.0


class _Nan(nn.Module):
    def forward(self, x):
        return x * float("nan")


def test_nan_hooks_name_the_module():
    model = nn.Sequential()
    model.add_module("first", nn.Linear(3, 3))
    model.add_module("bad", nn.Sequential(nn.ReLU(), _Nan()))
    x = torch.rand(2, 3)
    model[0](x)
    with utils.nan_hooks(model):
        with pytest.raises(ValueError, match=r"NaN detected in bad\.1"):
            model(x)
        model[0](x)  # finite: no raise
    model(x)  # the hooks are gone


def test_guard_and_assert_finite():
    step = utils.guard(lambda s, loss: (s, {"loss": torch.tensor(loss)}))
    assert step(1, 0.5)[0] == 1
    with pytest.raises(ValueError, match="train loss"):
        step(1, float("nan"))
    tree = {"params": nn.Linear(2, 2).state_dict(), "stats": [torch.zeros(2), torch.ones(1)]}
    utils.assert_finite(tree, "state/")
    tree["stats"][1][0] = float("inf")
    with pytest.raises(ValueError, match="non-finite values in state/stats/1"):
        utils.assert_finite(tree, "state/")


def test_csv_logger_and_get_logger(tmp_path):
    log = utils.CSVLogger(str(tmp_path / "epochs.csv"))
    log.log({"epoch": 0, "loss": 1.5})
    log.log({"epoch": 1, "loss": 0.5, "extra": 3})
    with open(tmp_path / "epochs.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows == [{"epoch": "0", "loss": "1.5"}, {"epoch": "1", "loss": "0.5"}]
    logger = utils.get_logger(str(tmp_path / "logs" / "run.log"), name="kmunet_torch_test")
    assert utils.get_logger(str(tmp_path / "other.log"), name="kmunet_torch_test") is logger
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in (tmp_path / "logs" / "run.log").read_text()
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def test_set_seed():
    draws = []
    for _ in range(2):
        utils.set_seed(7)
        draws.append((random.random(), float(np.random.rand()), float(torch.rand(()))))
    assert draws[0] == draws[1]
    assert os.environ["PYTHONHASHSEED"] == "7"


def test_trace_writes_a_trace(tmp_path):
    with utils.trace(str(tmp_path / "tb")) as prof:
        torch.rand(8, 8) @ torch.rand(8, 8)
    files = os.listdir(tmp_path / "tb")
    assert len(files) == 1 and files[0].endswith(".json")
    assert any("mm" in e.key for e in prof.key_averages())


def test_vis_channels_writes_a_png_per_frame(tmp_path):
    vis.vis_channels(np.random.default_rng(0).random((3, 8, 8)), str(tmp_path / "vis"), "p_")
    assert sorted(os.listdir(tmp_path / "vis")) == ["p_ch0.png", "p_ch1.png", "p_ch2.png"]
