"""The port on the card: the CUDA K5 gather, its grouped form K4, its
multiview form K7 and their K6 backward against their plain versions, the
gathers' gradients against the CPU's, and the forward and a train step
through them, on DySample's window and exact paths and for TrajGRU, against
the CPU's. Marked ``gpu``; they skip where there is no card. This file
imports no JAX, so it runs on a machine without
it: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kmunet_tpu_torch import serve
from kmunet_tpu_torch.kernels import bilinear
# By its own name (pytest puts tests/ on sys.path): tests/ has no __init__.py,
# so an installed regular package named ``tests`` would shadow ``tests.*``.
from torch_cases import (  # noqa: F401
    GATHER_CASES,
    GATHER_SHAPES,
    GROUPED_SHAPES,
    MULTIVIEW_SHAPES,
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
    TF32 off; 9 gather launches (DAGEM's deformable conv) per forward."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model_cpu = serve.build_km_unet_v3_sh(device="cpu", seed=2)
    model_gpu = serve.build_km_unet_v3_sh(device=cuda_device, seed=2)
    frames = np.random.default_rng(2).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    before = bilinear.bilinear_gather.launches
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert bilinear.bilinear_gather.launches == before + 9
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
    d_img 1e-6 of the sum of its terms' |values| (the atomics and warp sums
    add in another order); bf16 against the kernel's own fp32 result on the
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
    chip_smoke.py's helpers and bounds: 9 K5 and 9 K6 launches; the loss,
    the grad norm and every parameter's gradient (the ones the optimizer
    applied) within ``chip_smoke.compare_steps``'s stated tolerances."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.sh_config(2, "float32", drop_path=0.0, img_size=32, seq_len=9,
                               out_frames=4)
    batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        before = (bilinear.bilinear_gather.launches, bilinear.bilinear_gather_backward.launches)
        runs[device.type] = chip_smoke.step_gradients(cfg, device, batch, seed=1)
        launched = (bilinear.bilinear_gather.launches - before[0],
                    bilinear.bilinear_gather_backward.launches - before[1])
        assert launched == ((9, 9) if device.type == "cuda" else (0, 0))
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
    9 K5 and 3 K4 launches per forward, within 1e-4 abs."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    frames = np.random.default_rng(2).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    model_gpu = serve.build_km_unet_v3_sh(device=cuda_device, seed=2, dysample_window=False)
    _, reach = chip_smoke.reach_offsets(torch, model_gpu, torch.from_numpy(frames).to(cuda_device),
                                        2.0)
    assert max(reach) > 1.0
    model_cpu = serve.build_km_unet_v3_sh(device="cpu", seed=2, dysample_window=False)
    model_cpu.load_state_dict(model_gpu.state_dict())
    before = (bilinear.bilinear_gather.launches, bilinear.bilinear_gather_grouped.launches)
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert (bilinear.bilinear_gather.launches - before[0],
            bilinear.bilinear_gather_grouped.launches - before[1]) == (9, 3)
    want = serve.predict(model_cpu, frames).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cuda_exact_path_train_step_matches_cpu(cuda_device, monkeypatch):
    """``test_cuda_train_step_matches_cpu`` on DySample's exact path: 9 K5,
    9 K6, 3 K4 and 3 grouped K6 launches, within ``chip_smoke.compare_steps``."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.sh_config(2, "float32", drop_path=0.0, img_size=32, seq_len=9,
                               out_frames=4)
    batch = np.random.default_rng(7).random((2, 9, 32, 32), dtype=np.float32)
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_backward,
                bilinear.bilinear_gather_grouped, bilinear.bilinear_gather_grouped_backward)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        before = [c.launches for c in counters]
        runs[device.type] = chip_smoke.step_gradients(cfg, device, batch, seed=1,
                                                      dysample_window=False)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([9, 9, 3, 3] if device.type == "cuda" else [0, 0, 0, 0])
    chip_smoke.compare_steps(runs["cuda"], runs["cpu"])


def _multiview(shape, case, device, dtype):
    img, x, y, g = multiview_inputs(MULTIVIEW_SHAPES[shape], case)
    img_t, g_t = (torch.from_numpy(a).to(device, dtype) for a in (img, g))
    x_t, y_t = (torch.from_numpy(a).to(device) for a in (x, y))
    return img_t, x_t, y_t, g_t


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
    cfg = chip_smoke.trajgru_config(2, "float32", img_size=32, seq_len=9, out_frames=4)
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
