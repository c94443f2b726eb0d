#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kmunet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device  -- the card's name; ``nvidia-smi``'s name and power limit line.
2. build   -- K5 (``kmunet_tpu_torch/csrc/bilinear_gather.cu``) and K6
              (``csrc/bilinear_gather_backward.cu``) built with nvcc for
              sm_90a, one nvcc each, both started together; the
              ``-Xptxas -v`` reports are printed once.
3. kernel  -- K5 and K6 against their plain PyTorch versions on the card,
              zeros and border modes, fp32/bf16/fp16, at the DAGEM bridge
              shape, a ragged one and one whose C takes no 16-byte vectors,
              on out-of-range, integer, last-pixel,
              grid and far-outside coordinates. K5: fp32 within 1e-5 abs of
              the plain version; bf16 and fp16 within one ulp of the
              kernel's fp32 result on the same rounded image. K6: fp32
              within 1e-5 abs + 1e-5 relative of the plain version, plus
              for d_img 1e-6 of the sum of its terms' |values| (about 17
              fp32 ulps of it: its atomics add those terms, as many as the
              outputs that land on the pixel, in another order, and so do
              the warp sums of d_x and d_y); bf16 and fp16 against the
              kernel's own fp32 result on the same rounded image and
              gradient: d_img within one ulp plus that slack, d_x and d_y
              (fp32) within the slack.
4. slice   -- the serving path: KM_UNetV3-SH at full width (embed_dims
              16/32/64, 128^2, 5 -> 20 frames), seeded weights, eval mode,
              built and served through ``kmunet_tpu_torch.serve`` on the card
              for a few requests of B=2 in fp32 with TF32 off. Every kernel's
              launch count is set to 0 just before and read just after; K5
              must launch 9 times per forward. Each answer must have the
              shape (2, 128, 128, 20), be finite and match the same weights
              on the CPU (plain gather) within 1e-4 abs.
5. train   -- the training path, through ``kmunet_tpu_torch.train.engine``:
              the SH recipe (hybrid loss, AdamW, per-epoch cosine) at full
              width, 128^2, seq_len 25, B=16, bf16 compute, takes 3 steps on
              ``SyntheticNowcastDataset`` items from a seed, with the launch
              counts set to 0 just before and read just after: K5 and K6 must
              launch 9 times per step, every loss must be finite and the
              parameters must move. Then one fp32 step at B=2 with TF32 off
              on the card against the same step on the CPU: loss within 1e-5
              relative, grad norm within 5e-5 relative, and every parameter's
              gradient (the ones the optimizer applied) within 1e-3 of that
              parameter's largest |gradient| plus 1e-6 abs (the floor of the
              leaves whose exact gradient is 0, where both sides hold
              rounding noise).
6. timing  -- CUDA events after warm-up, PyTorch's default TF32 settings:
              the forward at B=128 bf16 and B=8 fp32 (ms, frames/s =
              B*20/s); the train step at B=16 and B=32 bf16 (ms); K5 and K6
              at the bridge shape in bf16 beside their bounds, their plain
              versions and the PyTorch call that computes the same function
              (``F.grid_sample``, ``aten.grid_sampler_2d_backward``) on the
              same data, each per call by CUDA events (``ms``: what a caller
              waits, host issue included) and by the profiler's device time
              (``device_ms``).
Then the kernels line, and last ``{"ok": true, "device": {...}}``. Any failed
phase raises: the run exits non-zero and prints no result, also when no CUDA
device is present. A hard deadline ends a run that hangs.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import subprocess
import sys
import time

DEADLINE_S = 900
REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
REQUESTS = 3
REQUEST_BATCH = 2
BRIDGE = (128, 16, 16, 64)  # K5's shape on the main path at B=128 (B, H, W, C)
RAGGED = (3, 7, 9, 24)
ODD = (2, 5, 6, 3)  # C of no 16-byte vector: one channel per thread
K5_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather.cu"
K5_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:646"
K6_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather_backward.cu"
K6_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:414"
TRAIN_STEPS = 3
TRAIN_BATCH = 16  # the bench's SH train step: 128^2, seq_len 25, bf16 compute
CHECK_BATCH = 2  # the fp32 card-vs-CPU step
# The fp32 card-vs-CPU step's bounds (also tests/test_torch_gpu.py's), a few
# times the gaps that scripts/torch_grad_precision.py reads on an H100: the
# grad norms 1.6e-5 apart at 32^2 (the card 1.2e-5 below the float64 norm,
# the CPU 3.5e-6 above it; spread over the large convs at 4x4-8x8, each
# 3.5-5e-5 off in its own norm) and 2.4e-6 at 128^2; each side's worst leaf
# within 4.2e-4 of its largest |float64 gradient|.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_NORM_RTOL = 5e-5
STEP_LEAF_RTOL = 1e-3
STEP_LEAF_ATOL = 1e-6  # the leaves whose exact gradient is 0 hold rounding noise
TAPS = 9  # DeformConv2d 3x3: one K5 launch per tap, one K6 launch per tap's backward


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line when it ends without error."""

    def __init__(self, name: str):
        self.name = name
        self.fields = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.fields

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": round(time.perf_counter() - self.t0, 3),
                  **self.fields})
        return False


def coordinate_cases(rng, B, H, W, Ho, Wo):
    """Named (x, y) pixel-coordinate fields, (B, Ho, Wo) float32 each."""
    import numpy as np

    shape = (B, Ho, Wo)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    jj = np.broadcast_to(np.arange(Wo) % W, shape)
    ii = np.broadcast_to((np.arange(Ho) % H)[:, None], shape)
    return {
        "spread": (f32(rng.uniform(-1.5, W + 0.5, shape)), f32(rng.uniform(-1.5, H + 0.5, shape))),
        "integer": (f32(rng.integers(-1, W + 1, shape)), f32(rng.integers(-1, H + 1, shape))),
        "last_pixel": (f32(np.full(shape, W - 1)), f32(np.full(shape, H - 1))),
        "grid": (f32(jj), f32(ii)),
        "far_outside": (
            f32(np.where(rng.uniform(size=shape) < 0.5, -2.0 - rng.uniform(0, 9, shape),
                         W + 1.0 + rng.uniform(0, 9, shape))),
            f32(np.where(rng.uniform(size=shape) < 0.5, -1e6, H + 1e3 * rng.uniform(size=shape))),
        ),
    }


def ulp_tolerance(torch, ref, dtype):
    """One ulp of ``dtype`` at the magnitude of the fp32 ``ref`` (at least the
    spacing of its subnormals)."""
    bits = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - bits)
    return ulp.clamp_min(torch.finfo(dtype).smallest_normal * 2.0 ** (1 - bits))


def ptxas_summary(output: str):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its template arguments, registers and spills."""
    name = "?"
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelI(.*?)EEvP", line)
        if m:
            name = m.group(1)
        elif "Used" in line or "spill" in line:
            yield f"ptxas {name}: {line.split(':', 1)[-1].strip()}"


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float | None:
    """Mean device time of ``fn()`` per call, summed over the kernels it
    launches, from ``torch.profiler``: unlike ``cuda_ms`` it leaves out the
    gaps in which the device waits for the host to issue the next call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    return total_us / 1e3 / iters if total_us > 0 else None  # None: no CUPTI trace


def check_close(name, got, want, tol) -> float:
    """Raises unless |got - want| <= tol elementwise; returns the max error."""
    err = (got.float() - want.float()).abs()
    bad = err > tol
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{name}: got {float(got.flatten()[i])}, want "
                             f"{float(want.flatten()[i])}, tolerance {float(tol.flatten()[i])}")
    return float(err.max())


def gather_bound(torch, img, x, n_out, backward: bool):
    """(bound_ms, bound_by, bytes, ops) of K5 or K6 on these inputs: each
    input read once and each output written once, over the HBM rate, against
    the fp32 operations over the fp32 rate. K5 reads img, x, y and writes
    out; K6 reads img, g, x, y and writes d_img, d_x, d_y. Operations per
    output element: K5 three lerps of 3; K6 7 for each coordinate term and a
    multiply and an add into each of the 4 taps of d_img."""
    esz = img.element_size()
    coords = 2 * x.numel() * 4
    if backward:
        moved = 2 * img.numel() * esz + n_out * esz + 2 * coords
        ops = 22 * n_out
    else:
        moved = img.numel() * esz + coords + n_out * esz
        ops = 9 * n_out
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, ops


def synthetic_batch(np, B, seed):
    """B items of the synthetic SH corpus (128^2, seq_len 25) from ``seed``."""
    from kmunet_tpu_torch.data import SyntheticNowcastDataset

    data = SyntheticNowcastDataset(length=B, img_size=128, seq_len=25, seed=seed)
    return np.stack([data[i] for i in range(B)])


def sh_config(B, dtype, drop_path=0.1, img_size=128, seq_len=25, out_frames=20):
    """The bench's SH train recipe (hybrid loss, AdamW, per-epoch cosine;
    128^2, seq_len 25, 5 -> 20) at batch B in compute ``dtype``."""
    from kmunet_tpu_torch.configs import shanghai_km_unet

    cfg = shanghai_km_unet()
    cfg.data.img_size, cfg.data.batch_size = img_size, B
    cfg.data.seq_len, cfg.data.out_frames = seq_len, out_frames
    cfg.model.num_classes = out_frames
    cfg.train.compute_dtype = dtype
    cfg.model.extra["drop_path"] = drop_path
    return cfg


def train_setup(cfg, device, seed=0):
    """(model, state, step, tx) of ``cfg`` with weights from ``seed``."""
    from kmunet_tpu_torch.train import engine

    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    state = engine.init_state(cfg, model, tx, seed=seed, device=device)
    return model, state, engine.make_train_step(model, engine.build_loss(cfg), tx, cfg), tx


def step_gradients(cfg, device, batch, seed=0):
    """One train step of ``cfg`` on ``device`` from weights made from
    ``seed``: (loss, grad norm, {name: gradient}), the gradients read on the
    CPU where the optimizer takes them, so they are the ones the step
    applied."""
    _, state, step, tx = train_setup(cfg, device, seed)
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.cpu() for g in grads]) or update(
        grads, st, params)
    _, m = step(state, batch)
    return float(m["loss"]), float(m["grad_norm"]), dict(zip(state.params, seen[0]))


def compare_steps(card, cpu):
    """Holds a card's ``step_gradients`` to the CPU's: the loss within
    STEP_LOSS_RTOL, the grad norm within STEP_GRAD_NORM_RTOL, every leaf's
    gradient within STEP_LEAF_RTOL of that leaf's largest |gradient| on the
    CPU plus STEP_LEAF_ATOL. Raises if not; returns the readings."""
    (loss_gpu, gn_gpu, g_gpu), (loss_cpu, gn_cpu, g_cpu) = card, cpu
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    gn_rel = abs(gn_gpu - gn_cpu) / gn_cpu
    leaf_ratio, worst = 0.0, ""
    for k, want in g_cpu.items():
        err = float((g_gpu[k] - want).abs().max())
        ratio = err / (STEP_LEAF_RTOL * float(want.abs().max()) + STEP_LEAF_ATOL)
        if ratio > leaf_ratio:
            leaf_ratio, worst = ratio, k
    readings = {"loss": [loss_gpu, loss_cpu], "grad_norm": [gn_gpu, gn_cpu], "loss_rel": loss_rel,
                "grad_norm_rel": gn_rel, "worst_leaf": worst, "worst_leaf_share_of_tol": leaf_ratio}
    if loss_rel > STEP_LOSS_RTOL or gn_rel > STEP_GRAD_NORM_RTOL or leaf_ratio > 1.0:
        raise AssertionError(f"card vs CPU fp32 step: {readings}")
    return readings


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F

    from kmunet_tpu_torch import serve
    from kmunet_tpu_torch.kernels import bilinear, build

    kernels = {"bilinear_gather": bilinear.bilinear_gather,
               "bilinear_gather_backward": bilinear.bilinear_gather_backward}

    def reset_counts():
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in kernels.items()}

    with Phase("device") as f:
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        card = smi.stdout.strip().splitlines()[0]
        f.update(kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
                 torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    with Phase("build") as f:
        sources = (bilinear.SOURCE, bilinear.BACKWARD_SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, started together
            builds = list(pool.map(build.build, sources))
        bilinear.forward_kernel()
        bilinear.backward_kernel()
        f.update(sources=[K5_SOURCE, K6_SOURCE],
                 libraries=[os.path.relpath(b.path, REPO) for b in builds],
                 nvcc_seconds=[round(b.seconds, 3) for b in builds])
    for source, built in zip(sources, builds):
        for line in ptxas_summary(built.compiler_output):
            print(f"{source} {line}", flush=True)

    dev = torch.device("cuda")
    errors = {}
    k6_errors = {}
    with Phase("kernel") as f:
        rng = np.random.default_rng(0)
        cases = []
        for shape_name, (B, H, W, C), (Ho, Wo) in (("bridge", BRIDGE, BRIDGE[1:3]),
                                                   ("ragged", RAGGED, (RAGGED[1] + 1, RAGGED[2] - 2)),
                                                   ("odd", ODD, (ODD[1] - 1, ODD[2] + 2))):
            img32 = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(dev)
            g32 = torch.from_numpy(rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)).to(dev)
            for case, (x, y) in coordinate_cases(rng, B, H, W, Ho, Wo).items():
                x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
                for mode in ("zeros", "border"):
                    # fp32: the kernel against the plain version. bf16/fp16:
                    # against the kernel's own fp32 result on the same
                    # (rounded) image, so that only the output rounding differs.
                    ref = bilinear.bilinear_gather_plain(img32, x, y, mode)
                    ref6 = bilinear.bilinear_gather_backward_plain(img32, x, y, g32, mode)
                    # Sum of |terms| of each d_img element (the tap weights are
                    # >= 0): many outputs may land on one pixel.
                    term_sums = bilinear.bilinear_gather_backward_plain(img32, x, y, g32.abs(), mode)
                    for dtype in (torch.float32, torch.bfloat16, torch.float16):
                        img, g = img32.to(dtype), g32.to(dtype)
                        key = f"{shape_name}/{case}/{mode}/{str(dtype)[6:]}"
                        got = bilinear.bilinear_gather_forward(img, x, y, mode).float()
                        if dtype == torch.float32:
                            want, tol = ref, torch.full_like(ref, 1e-5)
                        else:
                            want = bilinear.bilinear_gather_forward(img.float(), x, y, mode)
                            tol = ulp_tolerance(torch, want, dtype)
                        errors[key] = check_close(f"K5 {key}", got, want, tol)
                        # K6: atomics and warp sums add in another order.
                        got6 = bilinear.bilinear_gather_backward(img, x, y, g, mode)
                        if dtype == torch.float32:
                            want6 = ref6
                        else:
                            want6 = bilinear.bilinear_gather_backward(img.float(), x, y,
                                                                      g.float(), mode)
                        errs = []
                        for name, a, b in zip(("d_img", "d_x", "d_y"), got6, want6):
                            tol = 1e-5 + 1e-5 * b.abs()
                            if name == "d_img":
                                tol = tol + 1e-6 * term_sums[0]
                                if dtype != torch.float32:
                                    tol = tol + ulp_tolerance(torch, b, dtype)
                            errs.append(check_close(f"K6 {key} {name}", a, b, tol))
                        k6_errors[key] = max(errs)
                        cases.append(key)
        torch.cuda.synchronize()
        f.update(cases=len(cases), k5_max_abs_err=errors, k6_max_abs_err=k6_errors)

    path_launches = {}
    with Phase("slice") as f:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        model = serve.build_km_unet_v3_sh(device="cuda", dtype=torch.float32, seed=0)
        requests = [rng.uniform(size=(REQUEST_BATCH, 128, 128, 5)).astype(np.float32)
                    for _ in range(REQUESTS)]
        reset_counts()
        answers = [serve.predict(model, frames) for frames in requests]
        launches = path_launches["serve"] = read_counts()
        if launches["bilinear_gather"] != TAPS * REQUESTS:
            raise AssertionError(f"K5 launched {launches['bilinear_gather']} times in "
                                 f"{REQUESTS} forwards, want {TAPS} per forward")
        model_cpu = serve.build_km_unet_v3_sh(device="cpu", dtype=torch.float32, seed=0)
        slice_err = 0.0
        for frames, answer in zip(requests, answers):
            if tuple(answer.shape) != (REQUEST_BATCH, 128, 128, 20):
                raise AssertionError(f"answer shape {tuple(answer.shape)}")
            if not bool(torch.isfinite(answer).all()):
                raise AssertionError("answer has non-finite values")
            want = serve.predict(model_cpu, frames)
            slice_err = max(slice_err, float((answer.cpu() - want).abs().max()))
        if slice_err > 1e-4:
            raise AssertionError(f"card vs CPU forward: max abs err {slice_err} > 1e-4")
        f.update(requests=REQUESTS, batch=REQUEST_BATCH, launches=launches,
                 max_abs_err_vs_cpu=slice_err, tf32=False)
        del model, model_cpu, answers

    with Phase("train") as f:
        # The bench's step: full width, 128^2, B=16, bf16 compute, 3 steps.
        batch = torch.from_numpy(synthetic_batch(np, TRAIN_BATCH, seed=0)).to(dev)
        model, state, step, _ = train_setup(sh_config(TRAIN_BATCH, "bfloat16"), "cuda")
        before = [p.detach().clone() for p in state.params.values()]
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_counts()
        metrics = [step(state, batch, gen)[1] for _ in range(TRAIN_STEPS)]
        launches = path_launches["train"] = read_counts()
        for name, n in launches.items():
            if n != TAPS * TRAIN_STEPS:
                raise AssertionError(f"{name} launched {n} times in {TRAIN_STEPS} train steps, "
                                     f"want {TAPS} per step")
        losses = [float(m["loss"]) for m in metrics]
        grad_norms = [float(m["grad_norm"]) for m in metrics]
        if not np.isfinite(losses + grad_norms).all():
            raise AssertionError(f"non-finite train step: losses {losses}, grad norms {grad_norms}")
        moved = max(float((p.detach() - b).abs().max()) for p, b in zip(state.params.values(), before))
        if not moved > 0.0:
            raise AssertionError("the parameters did not move")
        del model, state, step, before, batch

        # One fp32 step on the card against the same step on the CPU, with no
        # stochastic depth: the two devices' generators draw differently.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        batch = synthetic_batch(np, CHECK_BATCH, seed=1)
        cfg = sh_config(CHECK_BATCH, "float32", drop_path=0.0)
        runs = {device: step_gradients(cfg, device, batch) for device in ("cuda", "cpu")}
        check = compare_steps(runs["cuda"], runs["cpu"])
        f.update(batch=TRAIN_BATCH, compute="bfloat16", steps=TRAIN_STEPS, losses=losses,
                 grad_norms=grad_norms, launches=launches, max_param_change=moved,
                 check_batch=CHECK_BATCH, check=check, tf32=False)
        del runs

    with Phase("timing") as f:
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        forward = {}
        for B, dtype, iters in ((128, torch.bfloat16, 5), (8, torch.float32, 10)):
            model = serve.build_km_unet_v3_sh(device="cuda", dtype=dtype, seed=0)
            frames = torch.rand(B, 128, 128, 5, device=dev).to(dtype)
            out = serve.predict(model, frames)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"B={B} {dtype} forward has non-finite values")
            ms = cuda_ms(torch, lambda: serve.predict(model, frames), iters)
            forward[f"B{B}_{str(dtype)[6:]}"] = {"ms": ms, "frames_per_s": B * 20 / (ms / 1e3)}
            del model, frames, out

        train = {}
        for B in (16, 32):
            model, state, step, _ = train_setup(sh_config(B, "bfloat16"), "cuda")
            batch = torch.rand(B, 25, 128, 128, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, lambda: step(state, batch, gen), 5)
            train[f"B{B}_bfloat16"] = {"ms": ms,
                                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del model, state, step, batch

        B, H, W, C = BRIDGE
        img = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        ii = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
        jj = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
        y = (ii + torch.randn(B, H, W, device=dev)).contiguous()  # a deformable tap
        x = (jj + torch.randn(B, H, W, device=dev)).contiguous()
        g = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        k5 = lambda: bilinear.bilinear_gather_forward(img, x, y, "zeros")  # noqa: E731
        k5_plain = lambda: bilinear.bilinear_gather_plain(img, x, y, "zeros")  # noqa: E731
        k6 = lambda: bilinear.bilinear_gather_backward(img, x, y, g, "zeros")  # noqa: E731
        k6_plain = lambda: bilinear.bilinear_gather_backward_plain(img, x, y, g, "zeros")  # noqa: E731
        grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1).to(img.dtype)
        img_nchw = img.permute(0, 3, 1, 2)  # the same NHWC memory, as an NCHW view
        g_nchw = g.permute(0, 3, 1, 2)

        def library():
            return F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        def library_backward():  # bilinear (0), zeros padding (0)
            return torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, True,
                                                           [True, True])

        k5_ms = cuda_ms(torch, k5, 200, 10)
        plain_ms = cuda_ms(torch, k5_plain, 20)
        library_ms = cuda_ms(torch, library, 200, 10)
        k5_device = device_ms(torch, k5, 50)
        plain_device = device_ms(torch, k5_plain, 10)
        library_device = device_ms(torch, library, 50)
        library_diff = float((library().permute(0, 2, 3, 1).float() - k5().float()).abs().max())
        bound_ms, bound_by, moved, ops = gather_bound(torch, img, x, B * H * W * C, False)

        k6_ms = cuda_ms(torch, k6, 200, 10)
        k6_plain_ms = cuda_ms(torch, k6_plain, 20)
        k6_library_ms = cuda_ms(torch, library_backward, 200, 10)
        k6_device = device_ms(torch, k6, 50)
        k6_plain_device = device_ms(torch, k6_plain, 10)
        k6_library_device = device_ms(torch, library_backward, 50)
        k6_bound_ms, k6_bound_by, k6_moved, k6_ops = gather_bound(torch, img, x, B * H * W * C,
                                                                  True)
        f.update(forward=forward, train_step=train, tf32_conv=True, k5_shape=list(BRIDGE),
                 k5_dtype="bfloat16", k5_ms=k5_ms, k5_plain_ms=plain_ms,
                 k5_library_ms=library_ms, k5_library_max_abs_diff=library_diff,
                 k5_bound_ms=bound_ms, k5_device_ms=k5_device,
                 k5_plain_device_ms=plain_device, k5_library_device_ms=library_device,
                 k5_bytes=moved, k5_ops=ops,
                 k6_ms=k6_ms, k6_plain_ms=k6_plain_ms, k6_library_ms=k6_library_ms,
                 k6_bound_ms=k6_bound_ms, k6_bound_by=k6_bound_by, k6_device_ms=k6_device,
                 k6_plain_device_ms=k6_plain_device, k6_library_device_ms=k6_library_device,
                 k6_bytes=k6_moved, k6_ops=k6_ops)

    def by_path(name):
        return {path: counts[name] for path, counts in path_launches.items()}

    emit({"kernels": [{
        "name": "bilinear_gather",
        "route": "cuda",
        "source": K5_SOURCE,
        "replaces": K5_REPLACES,
        "launches": sum(by_path("bilinear_gather").values()),
        "launches_by_path": by_path("bilinear_gather"),
        "max_abs_err": max(v for k, v in errors.items() if k.endswith("float32")),
        "max_abs_err_bfloat16": max(v for k, v in errors.items() if k.endswith("bfloat16")),
        "ms": k5_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "device_ms": k5_device,
        "plain_device_ms": plain_device,
        "library_device_ms": library_device,
    }, {
        "name": "bilinear_gather_backward",
        "route": "cuda",
        "source": K6_SOURCE,
        "replaces": K6_REPLACES,
        "launches": sum(by_path("bilinear_gather_backward").values()),
        "launches_by_path": by_path("bilinear_gather_backward"),
        "max_abs_err": max(v for k, v in k6_errors.items() if k.endswith("float32")),
        "max_abs_err_bfloat16": max(v for k, v in k6_errors.items() if k.endswith("bfloat16")),
        "ms": k6_ms,
        "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound_ms,
        "bound_by": k6_bound_by,
        "library_ms": k6_library_ms,
        "device_ms": k6_device,
        "plain_device_ms": k6_plain_device,
        "library_device_ms": k6_library_device,
    }]})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
