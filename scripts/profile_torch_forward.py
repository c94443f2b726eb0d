#!/usr/bin/env python3
"""Where the PyTorch port's KM_UNetV3-SH forward spends its time on the card.

    python3 scripts/profile_torch_forward.py [--batch 128] [--dtype bfloat16]

Prints JSON lines: the card (``nvidia-smi`` name and power limit); the time
of each top-level module of the model, from CUDA events recorded by forward
hooks (device time between the module's first and last kernel, so host gaps
while the device waits fall into it); and from ``torch.profiler`` the device
busy time of one forward against its wall time (the idle share) and the
kernels that take the most device time. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch import serve  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def module_times(model, frames, iters: int) -> dict:
    """Mean device ms per top-level module over ``iters`` forwards."""
    events: dict[str, list] = {}
    handles = []
    for name, child in model.named_children():
        def pre(_m, _inp, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])

        def post(_m, _inp, _out, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        handles += [child.register_forward_pre_hook(pre), child.register_forward_hook(post)]
    try:
        for _ in range(iters):
            serve.predict(model, frames)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: sum(a.elapsed_time(b) for a, b in evs) / iters for name, evs in events.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    dtype = getattr(torch, args.dtype)
    model = serve.build_km_unet_v3_sh(device="cuda", dtype=dtype, seed=0)
    frames = torch.rand(args.batch, 128, 128, 5, device="cuda").to(dtype)
    for _ in range(2):
        serve.predict(model, frames)
    torch.cuda.synchronize()
    emit({"card": card, "batch": args.batch, "dtype": args.dtype,
          "module_ms": module_times(model, frames, args.iters)})

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.predict(model, frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    emit({"wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:90], "count": e.count,
                           "ms": e.self_device_time_total / 1e3} for e in top]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
