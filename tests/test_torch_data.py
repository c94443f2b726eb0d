"""The port's data path against the JAX package's, on the CPU: the
Shanghai and LAPS items of files written under ``tmp_path``,
``split_indices``, both ``Resizer`` paths (the native core, the port's own
copy of ``km_loader.cc`` built into ``kmunet_tpu_torch/_build``, and numpy),
and the loader's batches over two shuffled epochs, equal to
``kmunet_tpu.data.DataLoader``'s; an abandoned iteration leaves no worker
thread alive."""

import threading
import time

import numpy as np
import pytest
import torch

import kmunet_tpu.native as native_jax
from kmunet_tpu.data import DataLoader as DataLoaderJax
from kmunet_tpu.data import LAPSDataset as LAPSDatasetJax
from kmunet_tpu.data import ShanghaiDataset as ShanghaiDatasetJax
from kmunet_tpu.data import SyntheticNowcastDataset as SyntheticJax
from kmunet_tpu.data import shanghai as shanghai_jax
from kmunet_tpu.data import split_indices as split_indices_jax
from kmunet_tpu.data.resize import Resizer as ResizerJax
from kmunet_tpu_torch.data import (DataLoader, LAPSDataset, ShanghaiDataset,
                                   SyntheticNowcastDataset, native, shanghai, split_indices)
from kmunet_tpu_torch.data.resize import Resizer
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

h5py = pytest.importorskip("h5py")


@pytest.fixture()
def shanghai_h5(tmp_path):
    """A file of the reference's layout (Shanghai.py:26,45-46) at 64 x 96."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "shanghai.h5")
    with h5py.File(path, "w") as f:
        for group, n in [("train", 6), ("test", 3)]:
            g = f.create_group(group)
            g.create_dataset("all_len", data=n)
            for i in range(n):
                g.create_dataset(str(i), data=rng.integers(0, 256, (25, 64, 96), dtype=np.uint8))
    return path


@pytest.fixture()
def laps_h5(tmp_path):
    path = str(tmp_path / "laps.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("vil", data=np.random.default_rng(1).random((40, 16, 16)))
    return path


def test_native_core_is_the_ports_own():
    assert native.load() is not None, "g++ is in this image: the native core must build"
    built = sorted(native.BUILD_DIR.glob("km_loader_*.so"))
    assert built and all(p.parent == native.PACKAGE_DIR / "_build" for p in built)
    assert native.SOURCE == native.PACKAGE_DIR / "csrc" / "km_loader.cc"


@pytest.mark.parametrize("group", ["train", "test", "val"])
def test_shanghai_items_match_jax(shanghai_h5, group):
    idx = [4, 1] if group == "train" else None
    ours = ShanghaiDataset(shanghai_h5, img_size=32, group=group, indices=idx, native_hw=(64, 96))
    ref = ShanghaiDatasetJax(shanghai_h5, img_size=32, group=group, indices=idx,
                             native_hw=(64, 96))
    assert len(ours) == len(ref) and ours.all_len == ref.all_len
    for i in range(len(ref)):
        got, want = ours[i], ref[i]
        assert got.shape == (25, 32, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ours.close()
    ref.close()


def test_shanghai_constants_match_jax():
    assert shanghai.PIXEL_SCALE == shanghai_jax.PIXEL_SCALE
    assert shanghai.THRESHOLDS == shanghai_jax.THRESHOLDS
    assert shanghai.BOUNDS == shanghai_jax.BOUNDS
    np.testing.assert_array_equal(shanghai.COLOR_MAP, shanghai_jax.COLOR_MAP)


@pytest.mark.parametrize("n", [0, 1, 5, 10, 11, 97])
def test_split_indices_match_jax(n):
    for got, want in zip(split_indices(n), split_indices_jax(n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_laps_items_match_jax(laps_h5, split):
    ours, ref = LAPSDataset(laps_h5, 8, split), LAPSDatasetJax(laps_h5, 8, split)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i], ref[i])
    vil = np.random.default_rng(2).random((30, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(LAPSDataset(vil=vil, split=split)[0],
                                  LAPSDatasetJax(vil=vil, split=split)[0])


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("in_hw,out_hw", [((64, 96), (32, 32)), ((40, 50), (64, 80))])
def test_resizer_matches_jax(path, in_hw, out_hw, monkeypatch):
    """Each path against JAX's same path: uint8 with the value scale folded
    in, and float32; numpy where no toolchain is (``native.load`` None)."""
    if path == "numpy":
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(native_jax, "load", lambda: None)
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, 3, *in_hw), dtype=np.uint8)
    f32 = rng.standard_normal((3, *in_hw)).astype(np.float32)
    ours, ref = Resizer(in_hw, out_hw), ResizerJax(in_hw, out_hw)
    got, want = ours.resize_scaled(u8, 1 / 255), ref.resize_scaled(u8, 1 / 255)
    if path == "numpy":
        assert got is None and want is None
    else:
        assert got.shape == (2, 3, *out_hw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got, want = ours(f32), ref(f32)
    assert got.shape == (3, *out_hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if path == "native" else 0)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_loader_batches_match_jax(shuffle, drop_last):
    """Two epochs of batches, as tensors on the asked device, equal to the
    JAX loader's (one process, no sharding: numpy batches)."""
    ds = SyntheticNowcastDataset(length=11, img_size=8, seq_len=3, seed=4)
    ref_ds = SyntheticJax(length=11, img_size=8, seq_len=3, seed=4)
    ours = DataLoader(ds, 4, shuffle=shuffle, seed=7, drop_last=drop_last, num_workers=3,
                      device="cpu")
    ref = DataLoaderJax(ref_ds, 4, shuffle=shuffle, seed=7, drop_last=drop_last, num_workers=3,
                        process_index=0, process_count=1)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
        epochs.append(torch.cat(got))
    assert ours.epoch == 2
    assert torch.equal(epochs[0], epochs[1]) != shuffle


def test_loader_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataLoader(SyntheticNowcastDataset(length=2, img_size=8, seq_len=3), 2)


def test_loader_abandoned_iteration_stops_its_threads():
    """Breaking out of an epoch (``--max_steps``) closes the batch
    generators: the feeder and the workers parked on the bounded queues
    drain out instead of staying alive."""
    before = threading.active_count()
    ds = SyntheticNowcastDataset(length=64, img_size=8, seq_len=3)
    it = iter(DataLoader(ds, 2, num_workers=4, prefetch=0, device="cpu"))
    next(it)
    assert threading.active_count() > before
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, (
        f"{threading.active_count() - before} loader threads left alive")
