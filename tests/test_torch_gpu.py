"""The port on the card: the CUDA K5 gather, its grouped form K4, its
multiview form K7 and their K6 backward against their plain versions, the
gathers' gradients against the CPU's, and the forward and a train step
through them, on DySample's window and exact paths and for TrajGRU, against
the CPU's; K8, the selective scan, and its backward against their plain
versions, and Mamba-UNet's forward and a train step through them; K1, the
fused KAN conv, and K2 and K3, the HSM-SSD compress and fused mixer, against
their plain versions, their gradients against the CPU's, and KM_UNetV3-SH's
forward and a train step through them; K3a, the mixer ablation, in its five
modes against its plain version; KM_UNetV3-LAPS's forward on each path and
a ``laps_km_unet()`` step through K1 and K3 against the CPU's; the
world-1 NCCL mesh step bit for bit the plain step; the baseline zoo's
forwards and "pic" steps against the CPU's, and its dropouts on a CUDA
generator by their statistics; the EfficientViM classifier's forward
through each HSM-SSD path against the CPU's, with K2's and K3's launches;
EnhancedViMBlock's layouts against the CPU's. Marked
``gpu``; they skip where there is no card. This file
imports no JAX, so it runs on a machine without
it: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kmunet_tpu_torch import serve
from kmunet_tpu_torch.kernels import ablate_mix, bilinear, kanconv, scan, ssd
from kmunet_tpu_torch.nn.layers import DropPath, Dropout
# By its own name (pytest puts tests/ on sys.path): tests/ has no __init__.py,
# so an installed regular package named ``tests`` would shadow ``tests.*``.
from torch_cases import (  # noqa: F401
    GATHER_CASES,
    GATHER_SHAPES,
    GROUPED_SHAPES,
    MULTIVIEW_SHAPES,
    coordinate_cases,
    cuda_device,
    gather_inputs,
    grouped_inputs,
    multiview_inputs,
    shifted_views,
)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_kernel_matches_plain(cuda_device, mode, shape, case, dtype):
    """fp32 within 1e-5 abs of the plain version; bf16 within one bf16 ulp
    of the kernel's fp32 result on the same rounded image."""
    img, x, y = gather_inputs(GATHER_SHAPES[shape], case)
    img_t = torch.from_numpy(img).to(cuda_device, dtype)
    x_t, y_t = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
    before = bilinear.bilinear_gather.launches
    got = bilinear.bilinear_gather(img_t, x_t, y_t, mode).float()
    torch.cuda.synchronize()
    assert bilinear.bilinear_gather.launches == before + 1
    if dtype == torch.float32:
        want = bilinear.bilinear_gather_plain(img_t, x_t, y_t, mode)
        tol = torch.full_like(want, 1e-5)
    else:
        want = bilinear.bilinear_gather(img_t.float(), x_t, y_t, mode)
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    assert bool(((got - want).abs() <= tol).all())


# K5 runs K7's kernel at G=1: a warp chunk of entries at the bridge's B=128
# (multiview_chunk 15), a thread per (entry, vector) pair at B=2 (chunk 0).
K5_SHAPES = {"bridge_b128": (128, 16, 16, 64), "ragged": GATHER_SHAPES["ragged"]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", list(K5_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_k5_runs_on_the_multiview_kernel(cuda_device, mode, shape, dtype):
    """K5 through K7's kernel at G=1, on every coordinate case: fp32 within
    1e-5 abs of the plain version, bf16 and fp16 within one ulp of the
    kernel's fp32 result on the same rounded image; one launch counted on
    ``bilinear_gather.launches`` a call, none on K7's counter."""
    B, H, W, C = K5_SHAPES[shape]
    chunk = bilinear.multiview_chunk(B, 1, H + 1, W - 2,
                                     torch.cuda.get_device_properties(0).multi_processor_count)
    assert (chunk > 0) == (shape == "bridge_b128")
    for case in GATHER_CASES:
        img, x, y = gather_inputs(K5_SHAPES[shape], case)
        img_t = torch.from_numpy(img).to(cuda_device)
        x_t, y_t = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
        before = (bilinear.bilinear_gather.launches, bilinear.bilinear_gather_multiview.launches)
        got = bilinear.bilinear_gather_forward(img_t.to(dtype), x_t, y_t, mode)
        torch.cuda.synchronize()
        assert (bilinear.bilinear_gather.launches,
                bilinear.bilinear_gather_multiview.launches) == (before[0] + 1, before[1])
        assert got.dtype == dtype and got.shape == (B, H + 1, W - 2, C)
        if dtype == torch.float32:
            want = bilinear.bilinear_gather_plain(img_t, x_t, y_t, mode)
            tol = torch.full_like(want, 1e-5)
        else:
            want = bilinear.bilinear_gather_forward(img_t.to(dtype).float(), x_t, y_t, mode)
            tol = chip_smoke.ulp_tolerance(torch, want, dtype)
        chip_smoke.check_close(f"K5 {shape} {case} {mode} {dtype}", got, want, tol)


def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    img = torch.zeros(1, 4, 4, 8, device=cuda_device)
    x = torch.zeros(1, 2, 2, device=cuda_device)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather(img.double(), x, x)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather(img, x.half(), x.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(img.permute(0, 2, 1, 3), x, x)
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(img, x.cpu(), x.cpu())


def test_cuda_forward_matches_cpu_plain_path(cuda_device, monkeypatch):
    """The card's forward, through the CUDA gather, against the CPU's, with
    TF32 off; one K7 launch (DAGEM's deformable conv, its 9 taps as the
    views) and no K5 launch per forward."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model_cpu = serve.build_km_unet_v3_sh(device="cpu", seed=2)
    model_gpu = serve.build_km_unet_v3_sh(device=cuda_device, seed=2)
    frames = np.random.default_rng(2).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_multiview)
    before = [c.launches for c in counters]
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, chip_smoke.DEFORM_CONVS]
    want = serve.predict(model_cpu, frames).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _grad_inputs(shape, case, device, dtype):
    img, x, y = gather_inputs(shape, case)
    g = np.random.default_rng(9).normal(size=x.shape + (shape[-1],)).astype(np.float32)
    img_t, g_t = (torch.from_numpy(a).to(device, dtype) for a in (img, g))
    x_t, y_t = (torch.from_numpy(a).to(device) for a in (x, y))
    return img_t, x_t, y_t, g_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_backward_kernel_matches_plain(cuda_device, mode, shape, case, dtype):
    """fp32 within 1e-5 abs + 1e-5 relative of the plain version, plus for
    d_img 1e-6 of the sum of its terms' |values| (its owner pass and warp
    sums add in another order); bf16 against the kernel's own fp32 result on the
    same rounded inputs, d_img within one bf16 ulp more."""
    img, x, y, g = _grad_inputs(GATHER_SHAPES[shape], case, cuda_device, dtype)
    before = bilinear.bilinear_gather_backward.launches
    got = bilinear.bilinear_gather_backward(img, x, y, g, mode)
    torch.cuda.synchronize()
    assert bilinear.bilinear_gather_backward.launches == before + 1
    if dtype == torch.float32:
        want = bilinear.bilinear_gather_backward_plain(img, x, y, g, mode)
    else:
        want = bilinear.bilinear_gather_backward(img.float(), x, y, g.float(), mode)
    term_sums = bilinear.bilinear_gather_backward_plain(img.float(), x, y, g.float().abs(), mode)[0]
    for name, a, b in zip(("d_img", "d_x", "d_y"), got, want):
        assert a.dtype == (dtype if name == "d_img" else torch.float32)
        tol = 1e-5 + 1e-5 * b.abs()
        if name == "d_img":
            tol = tol + 1e-6 * term_sums
            if dtype != torch.float32:
                tol = tol + torch.ldexp(torch.ones_like(b), torch.frexp(b).exponent - 8)
        assert bool(((a.float() - b).abs() <= tol).all()), name


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_gather_gradient_matches_cpu(cuda_device, mode):
    """Through ``BilinearGather``: K5 forward and K6 backward on the card
    against the plain versions on the CPU, fp32."""
    grads = {}
    for device in (cuda_device, torch.device("cpu")):
        img, x, y, g = _grad_inputs(GATHER_SHAPES["bridge"], "spread", device, torch.float32)
        img, x, y = (t.requires_grad_() for t in (img, x, y))
        before = (bilinear.bilinear_gather.launches, bilinear.bilinear_gather_backward.launches)
        bilinear.bilinear_gather(img, x, y, mode).backward(g)
        launched = (bilinear.bilinear_gather.launches - before[0],
                    bilinear.bilinear_gather_backward.launches - before[1])
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        grads[device.type] = [t.grad.cpu() for t in (img, x, y)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cuda_backward_kernel_rejects_what_it_does_not_take(cuda_device):
    img = torch.zeros(1, 4, 4, 8, device=cuda_device)
    x = torch.zeros(1, 2, 2, device=cuda_device)
    g = torch.zeros(1, 2, 2, 8, device=cuda_device)
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_backward(img, x, x, g.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_backward(img, x, x, g[:, :1])
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_backward(img, x, x, g.transpose(1, 2))


def test_cuda_train_step_matches_cpu(cuda_device, monkeypatch):
    """One fp32 SH train step (32^2, B2, seq 9 -> 4 outputs, no stochastic
    depth) on the card, TF32 off, against the same step on the CPU, with
    chip_smoke.py's helpers and bounds: 1 K7 and 1 K6 shared-source launch
    (the deformable conv), no K5 or K6 (G=1); the loss,
    the grad norm and every parameter's gradient (the ones the optimizer
    applied) within ``chip_smoke.compare_steps``'s stated tolerances."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.sh_config(2, "float32", drop_path=0.0, img_size=32, seq_len=9,
                               out_frames=4)
    batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_backward,
                bilinear.bilinear_gather_multiview, bilinear.bilinear_gather_multiview_backward)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        before = [c.launches for c in counters]
        runs[device.type] = chip_smoke.step_gradients(cfg, device, batch, seed=1)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([0, 0, 1, 1] if device.type == "cuda" else [0, 0, 0, 0])
    chip_smoke.compare_steps(runs["cuda"], runs["cpu"])


def _grouped(shape, case, device, dtype):
    img, x, y, g = grouped_inputs(GROUPED_SHAPES[shape], case)
    img_t, g_t = (torch.from_numpy(a).to(device, dtype) for a in (img, g))
    x_t, y_t = (torch.from_numpy(a).to(device) for a in (x, y))
    return img_t, x_t, y_t, g_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GROUPED_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_grouped_kernels_match_plain(cuda_device, mode, shape, case, dtype):
    """K4 and K6's grouped entry with the bounds of K5 and K6 above: fp32
    against the plain versions, bf16 against the kernels' own fp32 results
    on the same rounded inputs; Cg of 3 and 6 take one channel per thread."""
    img, x, y, g = _grouped(shape, case, cuda_device, dtype)
    before = (bilinear.bilinear_gather_grouped.launches,
              bilinear.bilinear_gather_grouped_backward.launches)
    got = bilinear.bilinear_gather_grouped_forward(img, x, y, mode).float()
    got_b = bilinear.bilinear_gather_grouped_backward(img, x, y, g, mode)
    torch.cuda.synchronize()
    assert (bilinear.bilinear_gather_grouped.launches,
            bilinear.bilinear_gather_grouped_backward.launches) == (before[0] + 1, before[1] + 1)
    if dtype == torch.float32:
        want = bilinear.bilinear_gather_grouped_plain(img, x, y, mode)
        tol = torch.full_like(want, 1e-5)
        want_b = bilinear.bilinear_gather_grouped_backward_plain(img, x, y, g, mode)
    else:
        want = bilinear.bilinear_gather_grouped_forward(img.float(), x, y, mode)
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
        want_b = bilinear.bilinear_gather_grouped_backward(img.float(), x, y, g.float(), mode)
    assert bool(((got - want).abs() <= tol).all())
    term_sums = bilinear.bilinear_gather_grouped_backward_plain(
        img.float(), x, y, g.float().abs(), mode)[0]
    for name, a, b in zip(("d_img", "d_x", "d_y"), got_b, want_b):
        assert a.dtype == (dtype if name == "d_img" else torch.float32)
        tol = 1e-5 + 1e-5 * b.abs()
        if name == "d_img":
            tol = tol + 1e-6 * term_sums
            if dtype != torch.float32:
                tol = tol + torch.ldexp(torch.ones_like(b), torch.frexp(b).exponent - 8)
        assert bool(((a.float() - b).abs() <= tol).all()), name


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_grouped_gather_gradient_matches_cpu(cuda_device, mode):
    """Through ``BilinearGatherGrouped``: K4 forward and K6's grouped
    backward on the card against the plain versions on the CPU, fp32."""
    outs, grads = {}, {}
    for device in (cuda_device, torch.device("cpu")):
        img, x, y, g = _grouped("dysample", "spread", device, torch.float32)
        img, x, y = (t.requires_grad_() for t in (img, x, y))
        before = (bilinear.bilinear_gather_grouped.launches,
                  bilinear.bilinear_gather_grouped_backward.launches)
        out = bilinear.bilinear_gather_grouped(img, x, y, mode)
        out.backward(g)
        launched = (bilinear.bilinear_gather_grouped.launches - before[0],
                    bilinear.bilinear_gather_grouped_backward.launches - before[1])
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        outs[device.type] = out.detach().cpu()
        grads[device.type] = [t.grad.cpu() for t in (img, x, y)]
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=1e-5)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cuda_grouped_kernels_reject_what_they_do_not_take(cuda_device):
    img = torch.zeros(1, 4, 4, 8, device=cuda_device)
    x = torch.zeros(1, 4, 2, 2, device=cuda_device)
    g = torch.zeros(1, 2, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of G"):
        bilinear.bilinear_gather_grouped(img[..., :6], x, x)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather_grouped(img, x.half(), x.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_grouped(img, x[:, 0], x[:, 0])
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_grouped_backward(img, x, x, g.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_grouped_backward(img, x, x, g.transpose(1, 2))


def test_cuda_exact_path_forward_matches_cpu(cuda_device, monkeypatch):
    """``dysample_window=False`` on the card against the CPU, TF32 off, with
    each DySample's offsets scaled to reach 2 px (chip_smoke.reach_offsets):
    1 K7 and 3 K4 launches per forward, within 1e-4 abs."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    frames = np.random.default_rng(2).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    model_gpu = serve.build_km_unet_v3_sh(device=cuda_device, seed=2, dysample_window=False)
    _, reach = chip_smoke.reach_offsets(torch, model_gpu, torch.from_numpy(frames).to(cuda_device),
                                        2.0)
    assert max(reach) > 1.0
    model_cpu = serve.build_km_unet_v3_sh(device="cpu", seed=2, dysample_window=False)
    model_cpu.load_state_dict(model_gpu.state_dict())
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_multiview,
                bilinear.bilinear_gather_grouped)
    before = [c.launches for c in counters]
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 1, 3]
    want = serve.predict(model_cpu, frames).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cuda_exact_path_train_step_matches_cpu(cuda_device, monkeypatch):
    """``test_cuda_train_step_matches_cpu`` on DySample's exact path: 1 K7,
    1 K6 shared-source, 3 K4 and 3 grouped K6 launches (no K5 or K6 of
    G=1), within ``chip_smoke.compare_steps``."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.sh_config(2, "float32", drop_path=0.0, img_size=32, seq_len=9,
                               out_frames=4)
    batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_backward,
                bilinear.bilinear_gather_multiview, bilinear.bilinear_gather_multiview_backward,
                bilinear.bilinear_gather_grouped, bilinear.bilinear_gather_grouped_backward)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        before = [c.launches for c in counters]
        runs[device.type] = chip_smoke.step_gradients(cfg, device, batch, seed=1,
                                                      dysample_window=False)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([0, 0, 1, 1, 3, 3] if device.type == "cuda" else [0] * 6)
    chip_smoke.compare_steps(runs["cuda"], runs["cpu"])


def _multiview(shape, case, device, dtype):
    img, x, y, g = multiview_inputs(MULTIVIEW_SHAPES[shape], case)
    img_t, g_t = (torch.from_numpy(a).to(device, dtype) for a in (img, g))
    x_t, y_t = (torch.from_numpy(a).to(device) for a in (x, y))
    return img_t, x_t, y_t, g_t


_K6_ENTRIES = {"gather": (bilinear.bilinear_gather_backward, GATHER_SHAPES),
               "grouped": (bilinear.bilinear_gather_grouped_backward, GROUPED_SHAPES),
               "multiview": (bilinear.bilinear_gather_multiview_backward, MULTIVIEW_SHAPES)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("entry", list(_K6_ENTRIES))
def test_cuda_backward_kernels_are_deterministic(cuda_device, entry, mode, case, dtype):
    """K6 adds floats with no atomics, each d_img element's terms in an order
    fixed by the inputs: two calls on the same inputs give bitwise equal
    d_img, d_x and d_y, at every shape of the entry (last_pixel puts every
    unit of a segment into one bin)."""
    backward, shapes = _K6_ENTRIES[entry]
    for shape in shapes:
        if entry == "gather":
            img, x, y, g = _grad_inputs(GATHER_SHAPES[shape], case, cuda_device, dtype)
        else:
            img, x, y, g = (_grouped if entry == "grouped" else _multiview)(
                shape, case, cuda_device, dtype)
        first = backward(img, x, y, g, mode)
        second = backward(img, x, y, g, mode)
        for name, a, b in zip(("d_img", "d_x", "d_y"), first, second):
            assert torch.equal(a, b), f"{shape} {name}"


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("entry", list(_K6_ENTRIES))
def test_cuda_backward_kernels_build_large_bins_in_global_memory(cuda_device, entry, mode,
                                                                 case):
    """A 16^2 source under 160^2 outputs: 25,600 units a segment, more than
    K6's bin pass stages in shared memory, so it builds the offsets and the
    lists in global memory (last_pixel: one bin of 25,600, sorted there).
    fp32 within the bounds of the tests above, and the same bits twice."""
    backward, _ = _K6_ENTRIES[entry]
    plain = {"gather": bilinear.bilinear_gather_backward_plain,
             "grouped": bilinear.bilinear_gather_grouped_backward_plain,
             "multiview": bilinear.bilinear_gather_multiview_backward_plain}[entry]
    if entry == "gather":
        rng = np.random.default_rng(9)
        img = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
        x, y = coordinate_cases(rng, 1, 16, 16, 160, 160)[case]
        g = rng.normal(size=(1, 160, 160, 8)).astype(np.float32)
    else:
        shape = (1, 16, 16, 8, 2, 160, 160)
        img, x, y, g = (grouped_inputs if entry == "grouped" else multiview_inputs)(shape, case)
    img, x, y, g = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                    for a in (img, x, y, g))
    got = backward(img, x, y, g, mode)
    assert all(torch.equal(a, b) for a, b in zip(got, backward(img, x, y, g, mode)))
    want = plain(img, x, y, g, mode)
    term_sums = plain(img, x, y, g.abs(), mode)[0]
    for name, a, b in zip(("d_img", "d_x", "d_y"), got, want):
        tol = 1e-5 + 1e-5 * b.abs() + (1e-6 * term_sums if name == "d_img" else 0.0)
        assert bool(((a - b).abs() <= tol).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(MULTIVIEW_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_multiview_kernels_match_plain(cuda_device, mode, shape, case, dtype):
    """K7 and K6's shared-source entry with the bounds of K5 and K6 above:
    fp32 against the plain versions, bf16 against the kernels' own fp32
    results on the same rounded inputs; C of 3 and 6 take one channel per
    thread, G=13 views all add into one d_img."""
    img, x, y, g = _multiview(shape, case, cuda_device, dtype)
    before = (bilinear.bilinear_gather_multiview.launches,
              bilinear.bilinear_gather_multiview_backward.launches)
    got = bilinear.bilinear_gather_multiview_forward(img, x, y, mode).float()
    got_b = bilinear.bilinear_gather_multiview_backward(img, x, y, g, mode)
    torch.cuda.synchronize()
    assert (bilinear.bilinear_gather_multiview.launches,
            bilinear.bilinear_gather_multiview_backward.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    if dtype == torch.float32:
        want = bilinear.bilinear_gather_multiview_plain(img, x, y, mode)
        tol = torch.full_like(want, 1e-5)
        want_b = bilinear.bilinear_gather_multiview_backward_plain(img, x, y, g, mode)
    else:
        want = bilinear.bilinear_gather_multiview_forward(img.float(), x, y, mode)
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
        want_b = bilinear.bilinear_gather_multiview_backward(img.float(), x, y, g.float(), mode)
    assert bool(((got - want).abs() <= tol).all())
    term_sums = bilinear.bilinear_gather_multiview_backward_plain(
        img.float(), x, y, g.float().abs(), mode)[0]
    for name, a, b in zip(("d_img", "d_x", "d_y"), got_b, want_b):
        assert a.dtype == (dtype if name == "d_img" else torch.float32)
        tol = 1e-5 + 1e-5 * b.abs()
        if name == "d_img":
            tol = tol + 1e-6 * term_sums
            if dtype != torch.float32:
                tol = tol + torch.ldexp(torch.ones_like(b), torch.frexp(b).exponent - 8)
        assert bool(((a.float() - b).abs() <= tol).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_multiview_view_l_lands_in_channel_block_l(cuda_device, dtype):
    """At integer coordinates K7's view l is the source shifted by
    (dy_l, dx_l), zeros outside, exactly."""
    img = np.random.default_rng(3).normal(size=(2, 6, 7, 16)).astype(np.float32)
    want, x, y = shifted_views(img, [(0, 0), (1, 0), (0, -2), (-1, 3), (2, 2)])
    got = bilinear.bilinear_gather_multiview_forward(
        torch.from_numpy(img).to(cuda_device, dtype), torch.from_numpy(x).to(cuda_device),
        torch.from_numpy(y).to(cuda_device), "zeros")
    assert torch.equal(got.cpu(), torch.from_numpy(want).to(dtype))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_multiview_gather_gradient_matches_cpu(cuda_device, mode):
    """Through ``BilinearGatherMultiview``: K7 forward and K6's shared-source
    backward on the card against the plain versions on the CPU, fp32."""
    outs, grads = {}, {}
    for device in (cuda_device, torch.device("cpu")):
        img, x, y, g = _multiview("g13_c16", "spread", device, torch.float32)
        img, x, y = (t.requires_grad_() for t in (img, x, y))
        before = (bilinear.bilinear_gather_multiview.launches,
                  bilinear.bilinear_gather_multiview_backward.launches)
        out = bilinear.bilinear_gather_multiview(img, x, y, mode)
        out.backward(g)
        launched = (bilinear.bilinear_gather_multiview.launches - before[0],
                    bilinear.bilinear_gather_multiview_backward.launches - before[1])
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        outs[device.type] = out.detach().cpu()
        grads[device.type] = [t.grad.cpu() for t in (img, x, y)]
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=1e-5)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cuda_multiview_kernels_reject_what_they_do_not_take(cuda_device):
    img = torch.zeros(1, 4, 4, 8, device=cuda_device)
    x = torch.zeros(1, 3, 2, 2, device=cuda_device)
    g = torch.zeros(1, 2, 2, 24, device=cuda_device)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather_multiview(img, x.half(), x.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_multiview(img, x[:, 0], x[:, 0])
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_multiview_backward(img, x, x, g[..., :8])
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_multiview_backward(img, x, x, g.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather_multiview_backward(img, x, x, g.transpose(1, 2))


def _model_shape_inputs(shape, case, device, dtype, seed=0, reach=1.0):
    """K7's inputs at a model shape: the source N(0, 1) and either flows
    (the output grid plus ``reach`` * N(0, 1) px) or a coordinate case of
    tests/torch_cases.py drawn for every view."""
    B, H, W, C, G, Ho, Wo = shape
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    if case == "flow":
        y = np.arange(Ho, dtype=np.float32)[:, None] + reach * rng.normal(size=(B, G, Ho, Wo))
        x = np.arange(Wo, dtype=np.float32) + reach * rng.normal(size=(B, G, Ho, Wo))
    else:
        x, y = (a.reshape(B, G, Ho, Wo) for a in coordinate_cases(rng, B * G, H, W, Ho, Wo)[case])
    img_t = torch.from_numpy(img).to(device, dtype)
    x_t, y_t = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in (x, y))
    return img_t, x_t, y_t


def _assert_k7_matches_plain(img, x, y, mode):
    """fp32 within 1e-5 abs of the plain version; bf16 and fp16 within one
    ulp (at least fp16's subnormal spacing) of the kernel's fp32 result on
    the same rounded image."""
    got = bilinear.bilinear_gather_multiview_forward(img, x, y, mode).float()
    if img.dtype == torch.float32:
        want = bilinear.bilinear_gather_multiview_plain(img, x, y, mode)
        tol = torch.full_like(want, 1e-5)
    else:
        want = bilinear.bilinear_gather_multiview_forward(img.float(), x, y, mode)
        tol = chip_smoke.ulp_tolerance(torch, want, img.dtype)
    assert bool(((got - want).abs() <= tol).all())


# K7's shapes on the model paths: TrajGRU's five at B=16, the deformable
# conv's 9 taps at the bridge at B=128.
K7_MODEL_SHAPES = {name: shape for name, (shape, _) in chip_smoke.MULTIVIEW_TIMING_SHAPES.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["flow", "spread", "far_outside"])
@pytest.mark.parametrize("shape", list(K7_MODEL_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_multiview_kernel_matches_plain_at_model_shapes(cuda_device, mode, shape, case,
                                                             dtype):
    """K7 at TrajGRU's five shapes (B=16) and the bridge's (B=128, G=9) with
    the bounds above, on flows of about 1 px, coordinates spread over the
    image and far outside it."""
    _assert_k7_matches_plain(*_model_shape_inputs(K7_MODEL_SHAPES[shape], case, cuda_device,
                                                  dtype), mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_multiview_kernel_at_large_flows(cuda_device, mode, dtype):
    """At enc_rnn1 (B=16, 32^2, C=64, G=13) flows of 12 px, with the bounds
    above."""
    _assert_k7_matches_plain(*_model_shape_inputs(K7_MODEL_SHAPES["enc_rnn1"], "flow",
                                                  cuda_device, dtype, seed=1, reach=12.0), mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["fore_rnn1", "rnn2", "bridge"])
def test_cuda_multiview_kernel_gives_the_same_bits_at_every_chunk(cuda_device, shape, dtype,
                                                                  monkeypatch):
    """A warp's chunk of 1 to 32 (output pixel, view) entries, or a thread
    per (entry, channel vector) pair (chunk 0), changes which lane blends an
    output, not its bits."""
    img, x, y = _model_shape_inputs(K7_MODEL_SHAPES[shape], "spread", cuda_device, dtype, seed=3)
    want = bilinear.bilinear_gather_multiview_forward(img, x, y, "zeros")
    for chunk in (0, 1, 3, 32):
        monkeypatch.setattr(bilinear, "multiview_chunk", lambda *args, chunk=chunk: chunk)
        assert torch.equal(bilinear.bilinear_gather_multiview_forward(img, x, y, "zeros"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", list(K7_MODEL_SHAPES))
def test_cuda_multiview_kernel_repeats_bitwise(cuda_device, shape, dtype):
    """Two calls on the same inputs give the same bits."""
    img, x, y = _model_shape_inputs(K7_MODEL_SHAPES[shape], "spread", cuda_device, dtype, seed=2)
    first = bilinear.bilinear_gather_multiview_forward(img, x, y, "zeros")
    assert torch.equal(first, bilinear.bilinear_gather_multiview_forward(img, x, y, "zeros"))


def test_cuda_deform_conv_matches_cpu(cuda_device, monkeypatch):
    """DAGEM's DeformConv2d (C=64 -> 64 at 16^2, B=2, offsets N(0, 1.5) px)
    in fp32 on the card, TF32 off, against the CPU: one K7 and one K6
    shared-source launch, the output within 1e-4 abs (the model forward's
    bound) and each gradient within ``chip_smoke``'s step bound of its
    largest |value|."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from kmunet_tpu_torch.nn import resample

    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    offset = (1.5 * rng.normal(size=(2, 16, 16, 18))).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    module = resample.DeformConv2d(64, 64)
    module.init_weights_(torch.Generator().manual_seed(12))
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_backward,
                bilinear.bilinear_gather_multiview, bilinear.bilinear_gather_multiview_backward)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        m = module.to(device)
        a, o = (torch.from_numpy(t).to(device).requires_grad_() for t in (x, offset))
        before = [c.launches for c in counters]
        out = m(a, o)
        out.backward(torch.from_numpy(g).to(device))
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([0, 0, 1, 1] if device.type == "cuda" else [0, 0, 0, 0])
        runs[device.type] = [t.detach().cpu() for t in (out, a.grad, o.grad, m.weight.grad)]
        m.zero_grad()
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=0, atol=1e-4)
    for got, want in zip(runs["cuda"][1:], runs["cpu"][1:]):
        tol = chip_smoke.STEP_LEAF_RTOL * float(want.abs().max()) + chip_smoke.STEP_LEAF_ATOL
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_cuda_trajgru_forward_matches_cpu(cuda_device, monkeypatch):
    """``build_zoo_model("trajgru")`` on the card against the CPU at 32^2,
    B=2, 5 -> 20 frames, TF32 off, each cell's flows scaled to reach 2 px
    (chip_smoke.reach_flows): 75 K7 launches per forward and no other
    kernel, within 1e-4 abs and 1e-5 of the largest |answer| (about 1e-2)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    frames = np.random.default_rng(2).uniform(size=(2, 5, 32, 32)).astype(np.float32)
    model_gpu = serve.build_zoo_model("trajgru", device=cuda_device, seed=2)
    _, reach = chip_smoke.reach_flows(torch, model_gpu, torch.from_numpy(frames).to(cuda_device),
                                      2.0)
    assert min(reach) > 1.0
    model_cpu = serve.build_zoo_model("trajgru", device="cpu", seed=2)
    model_cpu.load_state_dict(model_gpu.state_dict())
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_grouped,
                bilinear.bilinear_gather_multiview)
    before = [c.launches for c in counters]
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, chip_smoke.TRAJGRU_WARPS]
    want = serve.predict(model_cpu, frames).numpy()
    assert got.shape == (2, 20, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=min(1e-4, 1e-5 * np.abs(want).max()))


def test_cuda_trajgru_train_step_matches_cpu(cuda_device, monkeypatch):
    """One fp32 step of the ("trajgru", "pic") recipe at 32^2, B=2, seq 9 ->
    4 outputs, the flows scaled by chip_smoke.FLOW_SCALE, on the card against
    the CPU within ``chip_smoke.compare_steps``: 3*5 + 3*4 = 27 K7 and 27 K6
    shared-source launches."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.zoo_config("trajgru", 2, "float32", img_size=32, seq_len=9,
                                 out_frames=4)
    batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
    counters = (bilinear.bilinear_gather_multiview, bilinear.bilinear_gather_multiview_backward)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        before = [c.launches for c in counters]
        runs[device.type] = chip_smoke.step_gradients(cfg, device, batch, seed=1,
                                                      flow_scale=chip_smoke.FLOW_SCALE)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([27, 27] if device.type == "cuda" else [0, 0])
    chip_smoke.compare_steps(runs["cuda"], runs["cpu"])


K8_CHUNK = 64  # tokens per chunk of K8's kernels (csrc's kT)
# (B, L, D, N) of K8 on the card besides chip_smoke.py's, each with its dt
# cases: N of 1, 2 and 32, ragged D, L at the chunks' edges (one token short
# of a chunk, one chunk, one past it, three and one past them), and refine1
# at B=2 with dt "small": decays near 1, so the carries hold the whole
# sequence's memory over 256 chunks.
SCAN_GPU_SHAPES = {
    "encoder4": ((2, 256, 48, 16), chip_smoke.SCAN_DT_CASES),
    "ragged_l": ((2, 1000, 24, 16), chip_smoke.SCAN_DT_CASES),
    "d6_n4": ((2, 100, 6, 4), chip_smoke.SCAN_DT_CASES),
    "d24_n8": ((2, 77, 24, 8), chip_smoke.SCAN_DT_CASES),
    "l1": ((1, 1, 16, 16), chip_smoke.SCAN_DT_CASES),
    "d5_n32": ((2, 50, 5, 32), chip_smoke.SCAN_DT_CASES),
    "d130_n1": ((2, 40, 130, 1), chip_smoke.SCAN_DT_CASES),
    "d70_n2": ((2, 40, 70, 2), chip_smoke.SCAN_DT_CASES),
    "l_t_minus_1": ((2, K8_CHUNK - 1, 24, 16), chip_smoke.SCAN_DT_CASES),
    "l_t": ((2, K8_CHUNK, 24, 16), chip_smoke.SCAN_DT_CASES),
    "l_t_plus_1": ((2, K8_CHUNK + 1, 24, 16), chip_smoke.SCAN_DT_CASES),
    "l_3t_plus_1": ((2, 3 * K8_CHUNK + 1, 40, 8), chip_smoke.SCAN_DT_CASES),
    "refine1_small": ((2, 16384, 16, 16), ("small",)),
}


def _scan_args(shape, dt_case, device, seed=0):
    args, g = chip_smoke.scan_inputs(np, np.random.default_rng(seed), shape, dt_case)
    return [torch.from_numpy(a).to(device) for a in args], torch.from_numpy(g).to(device)


@pytest.mark.parametrize("shape,dt_case", [(shape, case) for shape, (_, cases)
                                           in SCAN_GPU_SHAPES.items() for case in cases])
def test_cuda_scan_kernels_match_plain(cuda_device, shape, dt_case):
    """K8 and its backward in fp32, bf16 and fp16 against the plain versions
    within ``chip_smoke.check_scan``'s tolerances (4 times the plain
    version's distance from float64, plus one ulp of the dtype); one launch
    of each per call."""
    assert [scan._chunks(2, L, 24, 16, True) for L in (K8_CHUNK, K8_CHUNK + 1)] == [1, 2]
    args, g = _scan_args(SCAN_GPU_SHAPES[shape][0], dt_case, cuda_device)
    ref, tols, _ = chip_smoke.scan_reference(torch, args, g)
    before = (scan.selective_scan.launches, scan.selective_scan_backward.launches)
    errors_f, errors_b = {}, {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        chip_smoke.check_scan(torch, shape, args, g, ref, tols, dtype, errors_f, errors_b)
    torch.cuda.synchronize()
    assert (scan.selective_scan.launches - before[0],
            scan.selective_scan_backward.launches - before[1]) == (3, 3)


def test_cuda_scan_backward_is_deterministic(cuda_device):
    """No atomics: two backward calls give the same bits."""
    args, g = _scan_args((2, 300, 40, 16), "mamba", cuda_device, seed=1)
    first = scan.selective_scan_backward(*args, g)
    second = scan.selective_scan_backward(*args, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_scan_forward_is_deterministic(cuda_device, dtype):
    """No atomics: two forward calls give the same bits, over five chunks and
    their carries."""
    args, _ = _scan_args((2, 300, 40, 16), "mamba", cuda_device, seed=1)
    args = [a.to(dtype) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    assert torch.equal(scan.selective_scan_forward(*args), scan.selective_scan_forward(*args))


def test_cuda_scan_gradient_matches_cpu(cuda_device):
    """``selective_scan`` through autograd on the card (K8 and its backward)
    against the CPU (the plain versions), fp32, with A and D in bf16 as the
    bf16 engine casts them: y and all six gradients within 1e-4 of each
    one's largest |value|, each gradient in its input's dtype."""
    args, g = _scan_args((2, 200, 24, 16), "mamba", cuda_device, seed=2)
    args[2], args[5] = args[2].bfloat16(), args[5].bfloat16()
    outs = {}
    for device in (cuda_device, torch.device("cpu")):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        y = scan.selective_scan(*leaves)
        y.backward(g.to(device))
        outs[device.type] = [y.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for name, a, b in zip(chip_smoke.SCAN_OUTPUTS, outs["cuda"], outs["cpu"]):
        assert a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= 1e-4 * float(b.float().abs().max()), name


def test_cuda_scan_rejects_what_it_does_not_take(cuda_device):
    args, g = _scan_args((2, 8, 4, 4), "mamba", cuda_device)
    x, dt, A, Bm, Cm, Dp = args
    with pytest.raises(ValueError, match="state size"):
        scan.selective_scan_forward(x, dt, torch.zeros(4, 3, device=cuda_device),
                                    Bm[..., :3].contiguous(), Cm[..., :3].contiguous(), Dp)
    with pytest.raises(TypeError):
        scan.selective_scan_forward(x.double(), dt.double(), A, Bm.double(), Cm.double(), Dp)
    with pytest.raises(TypeError):
        scan.selective_scan_forward(x, dt.half(), A, Bm, Cm, Dp)
    with pytest.raises(ValueError, match="contiguous"):
        scan.selective_scan_forward(x.transpose(0, 1).contiguous().transpose(0, 1), dt, A, Bm,
                                    Cm, Dp)
    with pytest.raises(ValueError):
        scan.selective_scan_backward(x, dt, A, Bm, Cm, Dp, g[:, :4])
    with pytest.raises(ValueError):
        scan.selective_scan_forward(x, dt, A, Bm[:, :4], Cm, Dp)


def test_cuda_mamba_forward_matches_cpu(cuda_device, monkeypatch):
    """``build_zoo_model("mamba_unet")`` on the card against the CPU at 32^2,
    B=2, 5 -> 20 frames, TF32 off: 20 K8 launches per forward (one
    MambaBlock on two views in each of the 10 DMFM layers) and no other
    kernel, within 1e-4 abs."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    frames = np.random.default_rng(3).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    model_gpu = serve.build_zoo_model("mamba_unet", device=cuda_device, seed=4)
    model_cpu = serve.build_zoo_model("mamba_unet", device="cpu", seed=4)
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_multiview, scan.selective_scan,
                scan.selective_scan_backward)
    before = [c.launches for c in counters]
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, chip_smoke.MAMBA_SCANS, 0]
    want = serve.predict(model_cpu, frames).numpy()
    assert got.shape == (2, 32, 32, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cuda_mamba_train_step_matches_cpu(cuda_device, monkeypatch):
    """One fp32 step of the ("mamba_unet", "pic") recipe at 32^2, B=2, seq 9
    -> 4 outputs on the card against the CPU's float64 gradient within
    ``chip_smoke.compare_steps``: 20 K8 and 20 K8-backward launches."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.zoo_config("mamba_unet", 2, "float32", img_size=32, seq_len=9,
                                 out_frames=4)
    batch = np.random.default_rng(8).random((2, 9, 32, 32), dtype=np.float32)
    before = (scan.selective_scan.launches, scan.selective_scan_backward.launches)
    card = chip_smoke.step_gradients(cfg, cuda_device, batch, seed=1)
    assert (scan.selective_scan.launches - before[0],
            scan.selective_scan_backward.launches - before[1]) == (20, 20)
    chip_smoke.compare_steps(card, chip_smoke.float64_gradients(cfg, batch, seed=1))


# K1's shapes (B, C, F, H, W): the four SH KAN convs at 32^2 input, LAPS's
# enc1 at 256^2 and B=1 (its grid's largest), and ragged ones; H and W past
# the kernel's 16 x 16 tiles, C of 24 and of 20 (no whole chunk of 8
# channels at the end), and F = 64 at a ragged H and W.
KAN_GPU_SHAPES = {
    "enc1": (2, 16, 16, 32, 32),
    "laps_enc1": (1, 16, 16, 256, 256),
    "enc3": (2, 32, 64, 8, 8),
    "dec1": (2, 64, 32, 8, 8),
    "ragged": (3, 3, 5, 7, 9),
    "f17": (1, 5, 17, 20, 18),
    "tile_edges": (2, 16, 16, 13, 35),
    "c24": (2, 24, 32, 10, 17),
    "c20": (2, 20, 16, 9, 16),
    "f64_ragged": (2, 32, 64, 11, 21),
}
# K2's and K3's (B, C, L, N): the SH mixer shapes at 32^2 input, LAPS's enc1
# at 256^2 and B=1 (L=65536: the most compress slices per batch element),
# ragged ones; the kernels' tile edges (L = T - 1, T + 1, 3T + 1 for their
# T = 64 tokens), an L whose bf16 rows are not 16-byte aligned (200 bytes;
# fp32 rows of 400 are), and C=64 with N=8 (states padded to 16); the
# EfficientViM classifier's mixers (chip_smoke's M4 and M1 stages at B=2:
# the kernels' wide path), C=72 with N=1, and N=9 and N=6 on the narrow
# path (odd state counts, padded to 16).
MIXER_GPU_SHAPES = {
    "enc1": (2, 16, 1024, 64),
    "laps_enc1": (1, 16, 65536, 64),
    "enc3": (2, 64, 64, 64),
    "ragged_n8": (2, 16, 1000, 8),
    "c3_n4": (3, 3, 77, 4),
    "l1": (2, 16, 1, 64),
    "t_minus_1": (2, 16, ssd.TILE - 1, 64),
    "t_plus_1": (2, 32, ssd.TILE + 1, 64),
    "3t_plus_1": (2, 16, 3 * ssd.TILE + 1, 16),
    "unaligned_bf16_l100": (2, 16, 100, 64),
    "c64_n8": (2, 64, 300, 8),
    **{name: shape for name, (shape, _) in chip_smoke.MIXER_SHAPES.items()
       if name.startswith(("m4_", "m1_", "c72_"))},
    "c24_n9": (2, 24, 16, 9),
    "c8_n6": (1, 8, 40, 6),
}


@pytest.mark.parametrize("case", chip_smoke.KAN_X_CASES)
@pytest.mark.parametrize("shape", list(KAN_GPU_SHAPES))
def test_cuda_kanconv_matches_plain(cuda_device, shape, case, monkeypatch):
    """K1 in fp32, bf16 and fp16 against the plain version within
    ``chip_smoke.check_kanconv``'s tolerances; one launch per call."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = chip_smoke.kan_inputs(torch, np.random.default_rng(0), KAN_GPU_SHAPES[shape], case,
                                 cuda_device)
    before = kanconv.fused_kanconv.launches
    chip_smoke.check_kanconv(torch, shape, *args, {})
    torch.cuda.synchronize()
    assert kanconv.fused_kanconv.launches - before == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", ["enc1", "ragged", "c20", "f64_ragged"])
def test_cuda_kanconv_repeats_bitwise(cuda_device, shape, dtype):
    """K1 called twice on the same inputs gives equal bits: each block owns
    its outputs and sums in a fixed order, with no atomics."""
    xp, base, spline = (t.to(dtype) for t in chip_smoke.kan_inputs(
        torch, np.random.default_rng(4), KAN_GPU_SHAPES[shape], "wide", cuda_device))
    assert torch.equal(kanconv.kanconv_forward(xp, base, spline),
                       kanconv.kanconv_forward(xp, base, spline))


@pytest.mark.parametrize("dt_case", ["seeded", "large"])
@pytest.mark.parametrize("shape", list(MIXER_GPU_SHAPES))
def test_cuda_mixer_kernels_match_plain(cuda_device, shape, dt_case, monkeypatch):
    """K2 and K3 in fp32, bf16 and fp16, dt, B and C strided slices of one
    bcdt, against the plain versions within ``chip_smoke.check_mixer``'s
    tolerances; one call of each per dtype."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    args = chip_smoke.mixer_inputs(torch, np.random.default_rng(1), MIXER_GPU_SHAPES[shape],
                                   dt_case, cuda_device)
    before = (ssd.hsmssd_compress.launches, ssd.hsmssd_mix.launches)
    chip_smoke.check_mixer(torch, shape, args, {}, {})
    torch.cuda.synchronize()
    assert (ssd.hsmssd_compress.launches - before[0], ssd.hsmssd_mix.launches - before[1]) == (3, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", ["enc1", "laps_enc1", "c3_n4", "c64_n8", "m4_stage0",
                                   "m1_stage2"])
def test_cuda_mixer_kernels_repeat_bitwise(cuda_device, shape, dtype):
    """K2 and K3 called twice on the same inputs give equal bits: no float
    atomics, the slices merged in order."""
    x, bcdt, A, w_hz, w_out, D = chip_smoke.mixer_inputs(
        torch, np.random.default_rng(3), MIXER_GPU_SHAPES[shape], "large", cuda_device)
    x, bcdt = x.to(dtype), bcdt.to(dtype)
    Bm, Cm, dt = bcdt.split(A.shape[0], dim=1)
    h = [ssd.hsmssd_compress_forward(x, dt, Bm, A) for _ in range(2)]
    mixed = [ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, D) for _ in range(2)]
    assert torch.equal(h[0], h[1])
    assert torch.equal(mixed[0][0], mixed[1][0]) and torch.equal(mixed[0][1], mixed[1][1])


def test_cuda_kanconv_and_mixer_gradients_match_cpu(cuda_device, monkeypatch):
    """``fused_kanconv``, ``hsmssd_compress`` and ``hsmssd_mix`` through
    autograd on the card (the kernels forward, the plain versions' autograd
    backward) against the CPU (the plain versions), fp32, TF32 off: outputs
    and gradients within 1e-5 of each one's largest |value| plus 1e-6; A's
    gradient, 0 in exact arithmetic (the softmax is shift-invariant per n),
    within 1e-4 of 0 on both sides, as tests/test_ssd_mix.py holds it (each
    side's fp32 noise reached 3.7e-6 on the card)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(2)
    kan_args = chip_smoke.kan_inputs(torch, rng, (2, 16, 32, 12, 10), "wide", "cpu")
    x, bcdt, A, w_hz, w_out, D = chip_smoke.mixer_inputs(torch, rng, (2, 32, 300, 64), "seeded",
                                                         "cpu")
    N = A.shape[0]

    def run(device):
        leaves = [t.to(device).requires_grad_() for t in (*kan_args, x, bcdt, A, w_hz, w_out, D)]
        xp, base, spline, xt, bc, a, wh, wo, d = leaves
        Bm, Cm, dt = bc.split(N, dim=1)
        y, h2 = ssd.hsmssd_mix(xt, dt, Bm, Cm, a, wh, wo, d)
        outs = (kanconv.fused_kanconv(xp, base, spline), ssd.hsmssd_compress(xt, dt, Bm, a), y, h2)
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        return [o.detach().cpu() for o in outs] + [t.grad.cpu() for t in leaves]

    counters = (kanconv.fused_kanconv, ssd.hsmssd_compress, ssd.hsmssd_mix)
    before = [c.launches for c in counters]
    got = run(cuda_device)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
    for i, (a, b) in enumerate(zip(got, run(torch.device("cpu")))):
        if i == 9:  # A's gradient
            assert float(a.abs().max()) <= 1e-4 and float(b.abs().max()) <= 1e-4
            continue
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-6, i


def test_cuda_kanconv_and_mixer_reject_what_they_do_not_take(cuda_device):
    xp, base, spline = chip_smoke.kan_inputs(torch, np.random.default_rng(3), (1, 4, 4, 6, 6),
                                             "unit", cuda_device)
    with pytest.raises(TypeError):
        kanconv.kanconv_forward(xp.double(), base, spline)
    with pytest.raises(TypeError):
        kanconv.kanconv_forward(xp, base.cpu(), spline)
    with pytest.raises(ValueError):
        kanconv.kanconv_forward(xp.transpose(2, 3), base, spline)
    x, bcdt, A, w_hz, w_out, D = chip_smoke.mixer_inputs(torch, np.random.default_rng(4),
                                                         (1, 8, 40, 8), "seeded", cuda_device)
    Bm, Cm, dt = bcdt.split(8, dim=1)
    with pytest.raises(TypeError):
        ssd.hsmssd_mix_forward(x.half(), dt, Bm, Cm, A, w_hz, w_out, D)
    with pytest.raises(ValueError):
        ssd.hsmssd_compress_forward(x, dt.transpose(1, 2).contiguous().transpose(1, 2), Bm, A)
    # Any N and C are taken; refused only where a pass's shared memory would
    # not fit a block (N in the thousands, which no model reaches).
    h = ssd.hsmssd_compress_forward(x, dt[:, :6], Bm[:, :6], A[:6])
    assert h.shape == (1, 6, 8)
    x, bcdt, A, w_hz, w_out, D = chip_smoke.mixer_inputs(torch, np.random.default_rng(5),
                                                         (1, 8, 40, 2048), "seeded", cuda_device)
    Bm, Cm, dt = bcdt.split(2048, dim=1)
    with pytest.raises(ValueError, match="shared memory"):
        ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, D)


@pytest.mark.parametrize("kan_fused,ssd_mixer", [(True, "fused"), (False, "compress")])
def test_cuda_kernel_paths_forward_matches_cpu(cuda_device, kan_fused, ssd_mixer, monkeypatch):
    """KM_UNetV3-SH at 32^2, B=2, with ``kan_fused`` and ``ssd_mixer`` on
    the card against the CPU, TF32 off, within 1e-4 abs: per forward 4 K1
    launches (or none), 15 of K3 or K2, 1 of K7 (the deformable conv)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    options = dict(kan_fused=kan_fused, ssd_mixer=ssd_mixer)
    frames = np.random.default_rng(5).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    model_gpu = serve.build_km_unet_v3_sh(device=cuda_device, seed=6, **options)
    model_cpu = serve.build_km_unet_v3_sh(device="cpu", seed=6, **options)
    counters = (bilinear.bilinear_gather_multiview, kanconv.fused_kanconv, ssd.hsmssd_compress,
                ssd.hsmssd_mix)
    before = [c.launches for c in counters]
    got = serve.predict(model_gpu, frames).cpu().numpy()
    mixers = chip_smoke.SSD_MIXERS
    assert [c.launches - b for c, b in zip(counters, before)] == [
        chip_smoke.DEFORM_CONVS, chip_smoke.KAN_CONVS if kan_fused else 0,
        mixers if ssd_mixer == "compress" else 0, mixers if ssd_mixer == "fused" else 0]
    np.testing.assert_allclose(got, serve.predict(model_cpu, frames).numpy(), rtol=0, atol=1e-4)


def test_cuda_fused_path_train_step_matches_cpu(cuda_device, monkeypatch):
    """One fp32 SH step (32^2, B2, seq 9 -> 4 outputs, no stochastic depth)
    through K1 and K3 on the card against the same step on the CPU within
    ``chip_smoke.compare_steps``: 4 K1, 15 K3, 1 K7 and 1 K6 shared-source
    launch."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.sh_config(2, "float32", drop_path=0.0, img_size=32, seq_len=9,
                               out_frames=4)
    batch = np.random.default_rng(9).random((2, 9, 32, 32), dtype=np.float32)
    options = dict(kan_fused=True, ssd_mixer="fused")
    counters = (kanconv.fused_kanconv, ssd.hsmssd_mix, bilinear.bilinear_gather_multiview,
                bilinear.bilinear_gather_multiview_backward)
    before = [c.launches for c in counters]
    card = chip_smoke.step_gradients(cfg, cuda_device, batch, seed=1, **options)
    assert [c.launches - b for c, b in zip(counters, before)] == [4, 15, 1, 1]
    chip_smoke.compare_steps(card, chip_smoke.step_gradients(cfg, "cpu", batch, seed=1, **options))


# K3a's (B, C, L, N, tile): several tiles of 64, C != N, one tile, N=8.
ABLATE_GPU_SHAPES = {
    "tile64": (2, 16, 1024, 64, 64),
    "c8_n32": (3, 8, 4096, 32, 1024),
    "one_tile": (2, 24, 512, 16, 512),
    "c5_n8": (1, 5, 256, 8, 128),
}


# K3a where a slice holds fewer 64-token tiles than the kernel's 4-stage
# ring (2 and 3 tiles a TPU tile) with C not a multiple of 8 (13, 20), and C
# = 40 (padded to 64 channels) over slices of 8 tiles.
ABLATE_RING_SHAPES = {
    "ring2_c13_n32": (2, 13, 2048, 32, 128),
    "ring3_c20_n16": (3, 20, 768, 16, 192),
    "c40_n64": (1, 40, 8192, 64, 4096),
}


@pytest.mark.parametrize("shape", list(ABLATE_RING_SHAPES))
def test_cuda_ablate_mix_short_slices_and_ragged_channels(cuda_device, shape):
    """K3a in its five modes against the plain version within
    ``chip_smoke.check_ablate``'s tolerance, at slices shorter than the
    ring and channels that pad to the products' width; one launch a mode."""
    name, shape = shape, ABLATE_RING_SHAPES[shape]
    B, C, L, _, tile = shape
    _, tps = ablate_mix._slices(B, L, tile,
                                torch.cuda.get_device_properties(0).multi_processor_count)
    assert tps < 4 if name.startswith("ring") else tps >= 4  # the ring's 4 stages
    args = chip_smoke.ablate_inputs(torch, shape, 9, cuda_device)
    before = ablate_mix.ablate_mix.launches
    chip_smoke.check_ablate(torch, "gpu", args, tile, {})
    torch.cuda.synchronize()
    assert ablate_mix.ablate_mix.launches - before == len(ablate_mix.MODES)


@pytest.mark.parametrize("shape", list(ABLATE_GPU_SHAPES))
def test_cuda_ablate_mix_matches_plain(cuda_device, shape, monkeypatch):
    """K3a in its five modes against the plain version within
    ``chip_smoke.check_ablate``'s tolerance; one call per mode."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shape = ABLATE_GPU_SHAPES[shape]
    args = chip_smoke.ablate_inputs(torch, shape, 7, cuda_device)
    before = ablate_mix.ablate_mix.launches
    chip_smoke.check_ablate(torch, "gpu", args, shape[4], {})
    torch.cuda.synchronize()
    assert ablate_mix.ablate_mix.launches - before == len(ablate_mix.MODES)


def test_cuda_ablate_mix_rejects_what_it_does_not_take(cuda_device):
    xt, dt, Bm, Cm, A = chip_smoke.ablate_inputs(torch, (1, 4, 256, 8, 0), 8, cuda_device)
    with pytest.raises(ValueError, match="64-token"):
        ablate_mix.ablate_mix_forward("full", xt, dt, Bm, Cm, A, 32)
    with pytest.raises(ValueError, match="state size"):
        ablate_mix.ablate_mix_forward("full", xt, *(t[..., :4].contiguous() for t in (dt, Bm, Cm)),
                                      A[:4], 64)
    with pytest.raises(ValueError, match="contiguous"):
        ablate_mix.ablate_mix_forward("full", torch.cat([xt, xt], -1)[..., ::2], dt, Bm, Cm, A,
                                      64)
    with pytest.raises(ValueError, match="CUDA"):
        ablate_mix.ablate_mix_forward("full", xt, dt.cpu(), Bm, Cm, A, 64)


LAPS_OPTIONS = {"plain": {}, "head_norm_off": {"head_norm": False},
                "fused": {"kan_fused": True, "ssd_mixer": "fused"},
                "compress": {"ssd_mixer": "compress"}}


@pytest.mark.parametrize("path", list(LAPS_OPTIONS))
def test_cuda_laps_forward_matches_cpu(cuda_device, path, monkeypatch):
    """KM_UNetV3-LAPS at 64^2, B=1, on each path on the card against the CPU,
    TF32 off, within 1e-4 abs: per forward 4 K1 launches on the kernel path,
    15 of K3 or K2 on theirs, none of any other kernel (no bridge, no
    DySample)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    options = LAPS_OPTIONS[path]
    frames = np.random.default_rng(10).uniform(size=(1, 64, 64, 5)).astype(np.float32)
    model_gpu = serve.build_km_unet_v3_laps(device=cuda_device, seed=6, **options)
    model_cpu = serve.build_km_unet_v3_laps(device="cpu", seed=6, **options)
    counters = (bilinear.bilinear_gather, kanconv.fused_kanconv, ssd.hsmssd_compress,
                ssd.hsmssd_mix)
    before = [c.launches for c in counters]
    got = serve.predict(model_gpu, frames).cpu().numpy()
    mixer = options.get("ssd_mixer")
    assert [c.launches - b for c, b in zip(counters, before)] == [
        0, chip_smoke.KAN_CONVS if options.get("kan_fused") else 0,
        chip_smoke.SSD_MIXERS if mixer == "compress" else 0,
        chip_smoke.SSD_MIXERS if mixer == "fused" else 0]
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, serve.predict(model_cpu, frames).numpy(), rtol=0, atol=1e-4)


def test_cuda_laps_train_step_matches_cpu(cuda_device, monkeypatch):
    """One fp32 ``laps_km_unet()`` step (32^2, B=1, seq 8 -> 3, no
    stochastic depth) through K1 and K3 on the card against the same step on
    the CPU within ``chip_smoke.compare_steps``: 4 K1 and 15 K3 launches."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.laps_config(1, "float32", drop_path=0.0, img_size=32)
    batch = np.random.default_rng(11).random((1, 8, 32, 32), dtype=np.float32)
    options = dict(kan_fused=True, ssd_mixer="fused")
    counters = (kanconv.fused_kanconv, ssd.hsmssd_mix)
    before = [c.launches for c in counters]
    card = chip_smoke.step_gradients(cfg, cuda_device, batch, seed=2, **options)
    assert [c.launches - b for c, b in zip(counters, before)] == [4, 15]
    chip_smoke.compare_steps(card, chip_smoke.step_gradients(cfg, "cpu", batch, seed=2, **options))


def test_cuda_world1_mesh_step_is_the_plain_step(cuda_device):
    """One process over NCCL on the card (``chip_smoke.spawn_ranks``): the
    SH recipe's B=16 bf16 step through a 1 x 1 x 1 mesh, whose collectives
    run on a group of one, bit for bit the plain step from the same weights,
    batch and generator state (``chip_smoke.dp_world1_job``), with K7 and
    K6's shared-source entry launched once each."""
    (world1,) = chip_smoke.spawn_ranks(torch, 1, chip_smoke.dp_world1_job)
    assert world1["collectives"], world1
    assert world1["bit_equal"], world1
    assert world1["launches"]["bilinear_gather_multiview"] == chip_smoke.DEFORM_CONVS
    assert world1["launches"]["bilinear_gather_multiview_backward"] == chip_smoke.DEFORM_CONVS


def _port_counts():
    return [k.launches for k in chip_smoke._kernel_counters().values()]


@pytest.mark.parametrize("name", chip_smoke.ZOO_MODELS)
def test_cuda_zoo_forward_and_step_match_cpu(cuda_device, name, monkeypatch):
    """Each baseline at full width, 64^2 (TransUNet's and Swin-UNet's
    shapes sized for it), fp32 with TF32 off: the forward at B=2 within
    1e-4 abs of the same weights on the CPU, and one step of its "pic"
    recipe (seq 9 -> 4, no dropout) in float64 against the CPU's within
    ``chip_smoke.compare_steps``, in fp32 against that within
    ``chip_smoke.fp32_step_distance``; no kernel of the port launched."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = _port_counts()
    model = serve.build_zoo_model(name, device=cuda_device, seed=3, img_size=64)
    model_cpu = serve.build_zoo_model(name, device="cpu", seed=3, img_size=64)
    frames = np.random.default_rng(12).uniform(size=(2, 64, 64, 5)).astype(np.float32)
    got = serve.predict(model, frames).cpu().numpy()
    assert got.shape == (2, 64, 64, 20)
    np.testing.assert_allclose(got, serve.predict(model_cpu, frames).numpy(), rtol=0, atol=1e-4)
    cfg = chip_smoke.zoo_step_config(name, 2, "float32", drop=False, img_size=64, seq_len=9,
                                     out_frames=4)
    batch = np.random.default_rng(13).random((2, 9, 64, 64), dtype=np.float32)
    with chip_smoke.zoo_dense_dropout(0.0):
        card = chip_smoke.step_gradients(cfg, cuda_device, batch, seed=4)
        card64 = chip_smoke.float64_gradients(cfg, batch, seed=4, device=cuda_device)
        exact = chip_smoke.float64_gradients(cfg, batch, seed=4)
    chip_smoke.compare_steps(card64, exact)
    chip_smoke.fp32_step_distance(card, exact)
    assert _port_counts() == before


@pytest.mark.parametrize("layer", [Dropout, DropPath])
def test_cuda_dropouts_by_their_statistics(cuda_device, layer):
    """On a CUDA generator: the share dropped near the rate, a kept element
    scaled by 1 / (1 - rate), the same generator state the same mask."""
    m = layer(0.2).train()
    x = torch.ones(4096, 8, 4, 4, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    state = g.get_state()
    y = m(x, g)
    assert abs(float((y == 0).float().mean()) - 0.2) < 0.01
    assert torch.unique(y).tolist() == [0.0, float(torch.tensor(1.0) / 0.8)]
    g.set_state(state)
    assert torch.equal(m(x, g), y)


@pytest.mark.parametrize("ssd_mixer", ["einsum", "compress", "fused"])
@pytest.mark.parametrize("variant", ["m1", "m4"])
def test_cuda_classifier_matches_cpu(cuda_device, variant, ssd_mixer, monkeypatch):
    """The EfficientViM classifier at full width, 224^2, B=2, fp32, TF32
    off, through ``serve``: within 1e-4 abs of the same weights on the
    CPU; K2 or K3 once per mixer (6 for M1, 9 for M4), neither with
    "einsum"."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    images = torch.from_numpy(np.random.default_rng(6).random((2, 224, 224, 3),
                                                              dtype=np.float32))
    want = serve.classify(serve.build_efficient_vim(variant, device="cpu"), images)
    model = serve.build_efficient_vim(variant, device=cuda_device, ssd_mixer=ssd_mixer)
    before = (ssd.hsmssd_compress.launches, ssd.hsmssd_mix.launches)
    got = serve.classify(model, images).cpu()
    torch.cuda.synchronize()
    n = chip_smoke.CLASSIFIER_MIXERS[variant]
    assert (ssd.hsmssd_compress.launches - before[0], ssd.hsmssd_mix.launches - before[1]) == (
        n if ssd_mixer == "compress" else 0, n if ssd_mixer == "fused" else 0)
    assert float((got - want).abs().max()) <= 1e-4


def test_cuda_vim_layouts_and_kan_variants_match_cpu(cuda_device, monkeypatch):
    """chip_smoke's vim_layouts and kan_variants phases: EnhancedViMBlock's
    four layouts and the KAN variants on the card against the CPU."""
    monkeypatch.setattr(chip_smoke, "VIM_TIMED_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "CLASSIFIER_TIMED_ITERS", 1)
    out = chip_smoke.vim_layouts_phase(torch, np, "card")
    assert out["fused_from_separate_max_abs_diff"] <= 1e-5
    chip_smoke.kan_variants_phase(torch, np, "card")
