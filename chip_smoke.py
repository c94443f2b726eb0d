#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kmunet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device  -- the card's name; ``nvidia-smi``'s name and power limit line.
2. build   -- K5 (``kmunet_tpu_torch/csrc/bilinear_gather.cu``) built with
              nvcc for sm_90a; the ``-Xptxas -v`` report is printed once.
3. kernel  -- K5 against its plain PyTorch version on the card, zeros and
              border modes, fp32/bf16/fp16, at the DAGEM bridge shape and a
              ragged one, on out-of-range, integer, last-pixel, grid and
              far-outside coordinates. fp32 within 1e-5 abs of the plain
              version; bf16 and fp16 within one ulp of the kernel's fp32
              result on the same rounded image.
4. slice   -- the main path: KM_UNetV3-SH at full width (embed_dims 16/32/64,
              128^2, 5 -> 20 frames), seeded weights, eval mode, built and
              served through ``kmunet_tpu_torch.serve`` on the card for a few
              requests of B=2 in fp32 with TF32 off. Every kernel's launch
              count is set to 0 just before and read just after; K5 must
              launch 9 times per forward. Each answer must have the shape
              (2, 128, 128, 20), be finite and match the same weights on the
              CPU (plain gather) within 1e-4 abs.
5. timing  -- CUDA events after warm-up, PyTorch's default TF32 settings:
              the forward at B=128 bf16 and B=8 fp32 (ms, frames/s =
              B*20/s); K5 at the bridge shape in bf16 beside its bound, its
              plain version and ``F.grid_sample`` on the same data, each per
              call by CUDA events (``ms``: what a caller waits, host issue
              included) and by the profiler's device time (``device_ms``).
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
K5_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather.cu"
K5_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:646"


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


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from kmunet_tpu_torch import serve
    from kmunet_tpu_torch.kernels import bilinear, build

    kernels = {"bilinear_gather": bilinear.bilinear_gather}

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
        built = build.build(bilinear.SOURCE)
        bilinear._library()
        f.update(source=K5_SOURCE, library=os.path.relpath(built.path, REPO),
                 nvcc_seconds=round(built.seconds, 3))
    for line in ptxas_summary(built.compiler_output):
        print(line, flush=True)

    dev = torch.device("cuda")
    errors = {}
    with Phase("kernel") as f:
        rng = np.random.default_rng(0)
        cases = []
        for shape_name, (B, H, W, C), (Ho, Wo) in (("bridge", BRIDGE, BRIDGE[1:3]),
                                                   ("ragged", RAGGED, (RAGGED[1] + 1, RAGGED[2] - 2))):
            img32 = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(dev)
            for case, (x, y) in coordinate_cases(rng, B, H, W, Ho, Wo).items():
                x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
                for mode in ("zeros", "border"):
                    # fp32: the kernel against the plain version. bf16/fp16:
                    # against the kernel's own fp32 result on the same
                    # (rounded) image, so that only the output rounding differs.
                    ref = bilinear.bilinear_gather_plain(img32, x, y, mode)
                    for dtype in (torch.float32, torch.bfloat16, torch.float16):
                        img = img32.to(dtype)
                        got = bilinear.bilinear_gather(img, x, y, mode).float()
                        if dtype == torch.float32:
                            want, tol = ref, torch.full_like(ref, 1e-5)
                        else:
                            want = bilinear.bilinear_gather(img.float(), x, y, mode)
                            tol = ulp_tolerance(torch, want, dtype)
                        err = (got - want).abs()
                        key = f"{shape_name}/{case}/{mode}/{str(dtype)[6:]}"
                        errors[key] = float(err.max())
                        cases.append(key)
                        bad = err > tol
                        if bool(bad.any()):
                            i = int(bad.flatten().nonzero()[0])
                            raise AssertionError(
                                f"K5 disagrees on {key}: got {float(got.flatten()[i])}, want "
                                f"{float(want.flatten()[i])}, tolerance {float(tol.flatten()[i])}")
        torch.cuda.synchronize()
        f.update(cases=len(cases), max_abs_err=errors)

    with Phase("slice") as f:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        model = serve.build_km_unet_v3_sh(device="cuda", dtype=torch.float32, seed=0)
        requests = [rng.uniform(size=(REQUEST_BATCH, 128, 128, 5)).astype(np.float32)
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        answers = [serve.predict(model, frames) for frames in requests]
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} was not launched on the main path")
        if launches["bilinear_gather"] != 9 * REQUESTS:
            raise AssertionError(f"K5 launched {launches['bilinear_gather']} times in "
                                 f"{REQUESTS} forwards, want 9 per forward")
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

        B, H, W, C = BRIDGE
        img = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        ii = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
        jj = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
        y = (ii + torch.randn(B, H, W, device=dev)).contiguous()  # a deformable tap
        x = (jj + torch.randn(B, H, W, device=dev)).contiguous()
        k5_ms = cuda_ms(torch, lambda: bilinear.bilinear_gather(img, x, y, "zeros"), 200, 10)
        plain_ms = cuda_ms(torch, lambda: bilinear.bilinear_gather_plain(img, x, y, "zeros"), 20)
        grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1).to(img.dtype)
        img_nchw = img.permute(0, 3, 1, 2)  # the same NHWC memory, as an NCHW view

        def library():
            return F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        library_ms = cuda_ms(torch, library, 200, 10)
        k5_device = device_ms(torch, lambda: bilinear.bilinear_gather(img, x, y, "zeros"), 50)
        plain_device = device_ms(torch, lambda: bilinear.bilinear_gather_plain(img, x, y, "zeros"), 10)
        library_device = device_ms(torch, library, 50)
        library_diff = float((library().permute(0, 2, 3, 1).float()
                              - bilinear.bilinear_gather(img, x, y, "zeros").float()).abs().max())
        n_out = B * H * W * C
        moved = img.numel() * img.element_size() + 2 * x.numel() * 4 + n_out * img.element_size()
        ops = 9 * n_out  # three lerps of (2 mul + 1 add) per output element, fp32
        bytes_ms = moved / H100_BYTES_PER_S * 1e3
        ops_ms = ops / H100_FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        f.update(forward=forward, tf32_conv=True, k5_shape=list(BRIDGE), k5_dtype="bfloat16",
                 k5_ms=k5_ms, k5_plain_ms=plain_ms, k5_library_ms=library_ms,
                 k5_library_max_abs_diff=library_diff, k5_bound_ms=bound_ms,
                 k5_device_ms=k5_device, k5_plain_device_ms=plain_device,
                 k5_library_device_ms=library_device,
                 k5_bytes=moved, k5_ops=ops)

    emit({"kernels": [{
        "name": "bilinear_gather",
        "route": "cuda",
        "source": K5_SOURCE,
        "replaces": K5_REPLACES,
        "launches": launches["bilinear_gather"],
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
    }]})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
