"""The port's metrics against the JAX package's, on the CPU.

``batch_metrics`` and ``Evaluator`` on the same seeded (B, T, H, W)
batches: the contingency counts exactly, the floats within 1e-6 relative
(plus 1e-6 absolute for values near 0). The cases hold values exactly on
the bins' edges (k / value_scale, whose product with value_scale may round
below k), an all-zero batch (NaN scores: degenerate denominators, and an
infinite PSNR) and several batches streamed. ``scatter_evaluate`` (numpy on
both sides) gives the same results and CSV rows exactly. LPIPS on seeded
random weights in the npz layout within 1e-5, and the two converters give
the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.metrics import evaluator as evaluator_jax
from kmunet_tpu.metrics import lpips as lpips_jax
from kmunet_tpu.metrics import scatter_eval as scatter_jax
from kmunet_tpu_torch.metrics import evaluator, lpips, scatter_eval

RTOL = 1e-6
ATOL = 1e-6
SH = ((20, 30, 35, 40), 90.0)
LAPS = ((0.1, 0.3, 0.5, 0.7, 0.8), 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(case, seed, shape=(2, 4, 32, 32), value_scale=90.0):
    """(true, pred) float32 of ``case``."""
    rng = np.random.default_rng(seed)
    if case == "zero":
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    true = rng.random(shape, dtype=np.float32)
    if case == "random":
        pred = np.clip(true + rng.normal(0, 0.1, shape), -0.1, 1.1).astype(np.float32)
    else:  # "edges": every value k / value_scale or its neighbour
        k = rng.integers(0, int(value_scale) + 1, shape)
        pred = (k / value_scale).astype(np.float32)
        step = rng.integers(-1, 2, shape)
        pred = np.nextafter(pred, pred + step).astype(np.float32)
        true[..., :8] = (k[..., :8] / value_scale).astype(np.float32)
    return true, pred


def _assert_floats(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", ["random", "edges", "zero"])
@pytest.mark.parametrize("kind", ["sh", "laps"])
def test_batch_metrics_match_jax(case, kind):
    thresholds, value_scale = SH if kind == "sh" else LAPS
    true, pred = _batch(case, seed=len(case), value_scale=value_scale)
    want = evaluator_jax.batch_metrics(jnp.asarray(true), jnp.asarray(pred), thresholds,
                                       value_scale)
    got = evaluator.batch_metrics(torch.from_numpy(true), torch.from_numpy(pred), thresholds,
                                  value_scale)
    assert got["cont"].dtype == torch.int64
    np.testing.assert_array_equal(got["cont"].numpy(), np.asarray(want["cont"]))
    for key in ("mae", "mse", "rmse", "psnr", "ssim"):
        _assert_floats(got[key].numpy(), np.asarray(want[key]), key)
    if case == "edges" and kind == "sh":  # the edges cross bins: the counts see both sides
        assert (got["cont"][..., 0] > 0).any() and (got["cont"][..., 1] > 0).any()


def _results_equal(got, want, what=""):
    """Dicts of scores: the same keys, equal strings, floats within the
    tolerance, NaN where the other is NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _results_equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        _assert_floats(np.asarray(got, np.float64), np.asarray(want, np.float64), what)
    elif isinstance(want, str):
        assert got == want, what
    else:
        _assert_floats(got, want, what)


@pytest.mark.parametrize("cases", [("random", "edges", "random"), ("zero",), ("zero", "edges")])
def test_evaluator_streams_like_jax(cases):
    """Several batches streamed through both evaluators: done() and
    per_horizon() alike (CSI, POD, HSS and FAR come from the same counts),
    NaN where JAX has NaN; and reset() starts anew."""
    thresholds, value_scale = SH
    ours = evaluator.Evaluator(seq_len=4, value_scale=value_scale, thresholds=thresholds)
    ref = evaluator_jax.Evaluator(seq_len=4, value_scale=value_scale, thresholds=thresholds)
    for ev in (ours, ref):
        ev.evaluate(*_batch("random", seed=99))
        ev.reset()
    for i, case in enumerate(cases):
        true, pred = _batch(case, seed=i)
        ours.evaluate(torch.from_numpy(true), torch.from_numpy(pred))
        ref.evaluate(true, pred)
    np.testing.assert_array_equal(ours._cont, ref._cont)
    np.testing.assert_array_equal(ours._cont_t, ref._cont_t)
    assert ours.total == ref.total == 2 * len(cases)
    done = ours.done()
    _results_equal(done, ref.done())
    _results_equal(ours.per_horizon(), ref.per_horizon())
    if cases == ("zero",):
        assert np.isnan(done["threshold_metrics"][20]["CSI"]) and np.isnan(done["FAR"])
        assert np.isnan(done["LPIPS"]) and "needs weights" in done["LPIPS_status"]


def test_scatter_evaluate_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    gts = rng.random((3, 3, 24, 24))
    preds = np.clip(gts + rng.normal(0, 0.15, gts.shape), 0, 1)
    gts[0, 0] = 0.0  # a thresholds' edge case: an all-dry frame
    for thresholds in (LAPS[0], (0.0, 2.0)):  # (0.0, 2.0): all wet, all dry
        paths = tmp_path / f"port{len(thresholds)}.csv", tmp_path / f"jax{len(thresholds)}.csv"
        for _ in range(2):  # the second call appends rows under the one header
            got = scatter_eval.scatter_evaluate(gts, preds, thresholds, csv_path=str(paths[0]),
                                                ssim_max_elems=3000)
            want = scatter_jax.scatter_evaluate(gts, preds, thresholds, csv_path=str(paths[1]),
                                                ssim_max_elems=3000)
            assert got == want
        assert paths[0].read_text() == paths[1].read_text()
        assert paths[0].read_text().count("Threshold") == 1
    assert scatter_eval.scatter_evaluate(gts, preds) == scatter_jax.scatter_evaluate(gts, preds)


def _lpips_state_dict(seed):
    """A torch ``lpips.LPIPS(net='alex')`` state_dict of seeded random
    weights under the package's keys."""
    convs = [(64, 11, "net.slice1.0"), (192, 5, "net.slice2.3"), (384, 3, "net.slice3.6"),
             (256, 3, "net.slice4.8"), (256, 3, "net.slice5.10")]
    g = torch.Generator().manual_seed(seed)
    sd, in_ch = {}, 3
    for i, (out_ch, k, key) in enumerate(convs):
        sd[f"{key}.weight"] = 0.1 * torch.randn(out_ch, in_ch, k, k, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(out_ch, generator=g)
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, out_ch, 1, 1, generator=g)
        in_ch = out_ch
    return sd


def test_lpips_converter_matches_jax(tmp_path):
    sd = _lpips_state_dict(0)
    got, want = lpips.convert_lpips_state_dict(sd), lpips_jax.convert_lpips_state_dict(sd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    torch.save(sd, tmp_path / "lpips.pth")
    lpips.convert_torch_lpips(str(tmp_path / "port.npz"), str(tmp_path / "lpips.pth"))
    lpips_jax.convert_torch_lpips(str(tmp_path / "jax.npz"), str(tmp_path / "lpips.pth"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in b)


def test_lpips_matches_jax(tmp_path):
    """make_lpips_fn on seeded weights: (B, T) distances within 1e-5 of
    JAX's; zero for identical frames; None without weights; and the
    Evaluator reports LPIPS with status ok."""
    npz = str(tmp_path / "lpips.npz")
    np.savez(npz, **lpips.convert_lpips_state_dict(_lpips_state_dict(1)))
    rng = np.random.default_rng(5)
    pred = rng.random((2, 3, 64, 64), dtype=np.float32)
    true = rng.random((2, 3, 64, 64), dtype=np.float32)
    fn = lpips.make_lpips_fn(npz, device="cpu")
    got = fn(torch.from_numpy(pred), torch.from_numpy(true)).numpy()
    want = np.asarray(lpips_jax.make_lpips_fn(npz)(jnp.asarray(pred), jnp.asarray(true)))
    assert got.shape == (2, 3) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fn(torch.from_numpy(pred), torch.from_numpy(pred)).numpy(), 0.0,
                               atol=1e-6)
    assert lpips.make_lpips_fn(None) is None
    ev = evaluator.Evaluator(seq_len=3, value_scale=90.0, lpips_fn=fn)
    ev.evaluate(torch.from_numpy(true), torch.from_numpy(pred))
    done = ev.done()
    assert done["LPIPS_status"] == "ok"
    np.testing.assert_allclose(done["LPIPS"], want.mean(), rtol=1e-5)


def test_lpips_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    npz = str(tmp_path / "lpips.npz")
    np.savez(npz, **lpips.convert_lpips_state_dict(_lpips_state_dict(2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lpips.make_lpips_fn(npz)
