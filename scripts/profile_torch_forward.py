#!/usr/bin/env python3
"""Where the PyTorch port's KM_UNetV3-SH, KM_UNetV3-LAPS, TrajGRU or
Mamba-UNet forward, or its train step, spends its time on the card.

    python3 scripts/profile_torch_forward.py [--batch 128] [--dtype bfloat16] [--exact]
    python3 scripts/profile_torch_forward.py --kan-fused --ssd-mixer fused [--train]
    python3 scripts/profile_torch_forward.py --train [--batch 16] [--exact]
    python3 scripts/profile_torch_forward.py --model trajgru [--train] [--batch 16]
    python3 scripts/profile_torch_forward.py --model mamba_unet [--train] [--batch 16]
    python3 scripts/profile_torch_forward.py --model laps [--kan-fused --ssd-mixer fused] [--train]

Prints JSON lines: the card (``nvidia-smi`` name and power limit); for the
forward, the time of each top-level module of the model, from CUDA events
recorded by forward hooks (device time between the module's first and last
kernel, so host gaps while the device waits fall into it); and from
``torch.profiler`` the device busy time of one forward (or one SH train
step: hybrid loss, AdamW, bf16 compute unless ``--dtype float32``, 128^2,
seq_len 25, on synthetic data) against its wall time (the idle share) and
the kernels that take the most device time, and the launches and device
time of the layout changes (PyTorch's copy kernels and cuDNN's NCHW <-> NHWC
transforms), and the launches and device time of each of the port's own
kernels (``port_kernels``). ``--exact`` runs DySample's
exact path (``dysample_window=False``: the K4 grouped gather) in place of
its window path. ``--kan-fused`` runs KM_UNetV3's four KAN convs through K1
and ``--ssd-mixer fused`` (or ``compress``) its 15 HSM-SSD mixers through K3
(or K2) in place of the plain convs and einsums. ``--model trajgru``
profiles TrajGRU_EF (5 -> 20 frames at 128^2, B=16 by default) and its ("trajgru", "pic") recipe step (Adam,
weighted_mse_mae); a cell's module time sums all its calls of a forward.
``--model mamba_unet`` profiles Mamba_UNet (5 -> 20 frames at 128^2, B=16
by default; 20 selective scans, K8, per forward) and its ("mamba_unet",
"pic") recipe step (SGD with momentum, rainfall loss, CosineAnnealingLR).
``--model laps`` profiles KM_UNetV3-LAPS (5 -> 3 frames at 256^2, B=32 by
default) and its ``laps_km_unet()`` step (B=1 by default, seq_len 8).
Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch import serve  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def port_kernels(kernels) -> dict:
    """{kernel: [launches, device ms]} for the port's own kernels (those of
    ``kmunet_tpu_torch/csrc``, at the top of their sources' anonymous
    namespaces; PyTorch's sit under ``at::``), by name without template
    arguments."""
    out = {}
    for e in kernels:
        key = e.key.removeprefix("void ")
        if not key.startswith("(anonymous namespace)::"):
            continue
        name = key.removeprefix("(anonymous namespace)::").split("<")[0].split("(")[0]
        count, ms = out.get(name, (0, 0.0))
        out[name] = (count + e.count, ms + e.self_device_time_total / 1e3)
    return {k: list(v) for k, v in sorted(out.items())}


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


def train_step(batch: int, dtype: str, window: bool, model_name: str, **options):
    """One train step at ``batch`` as a closure, after two warm-up steps: the
    SH recipe for km_unet_v3 (at 128^2), ``laps_km_unet()`` for laps (at its
    256^2), the (model, "pic") recipe for the zoo's (at 128^2)."""
    from kmunet_tpu_torch.configs import laps_km_unet, shanghai_km_unet
    from kmunet_tpu_torch.data import SyntheticNowcastDataset
    from kmunet_tpu_torch.train import engine
    from kmunet_tpu_torch.train.recipes import apply_recipe

    if model_name == "laps":
        cfg = laps_km_unet()
    else:
        cfg = shanghai_km_unet()
        if model_name != "km_unet_v3":
            cfg = apply_recipe(cfg, model_name, "pic")
        cfg.data.img_size = 128
    cfg.data.batch_size, cfg.train.compute_dtype = batch, dtype
    model = engine.build_model(cfg, dysample_window=window, **options)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    state = engine.init_state(cfg, model, tx, seed=0)
    step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
    data = SyntheticNowcastDataset(length=batch, img_size=cfg.data.img_size,
                                   seq_len=cfg.data.seq_len, seed=0)
    frames = torch.from_numpy(np.stack([data[i] for i in range(batch)])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        step(state, frames, gen)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    return run


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="km_unet_v3",
                   choices=["km_unet_v3", "laps", "trajgru", "mamba_unet"])
    p.add_argument("--batch", type=int, default=None,
                   help="default 16 for --train and for the zoo's models, else 128; "
                        "laps: 1 for --train, else 32")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--train", action="store_true", help="profile one train step")
    p.add_argument("--exact", action="store_true", help="DySample's exact path")
    p.add_argument("--kan-fused", action="store_true", help="KM_UNetV3's KAN convs through K1")
    p.add_argument("--ssd-mixer", default="einsum", choices=["einsum", "compress", "fused"],
                   help="KM_UNetV3's HSM-SSD mixers: einsums, K2 or K3")
    args = p.parse_args()
    options = dict(kan_fused=args.kan_fused, ssd_mixer=args.ssd_mixer)
    if args.model not in ("km_unet_v3", "laps") and (args.kan_fused
                                                     or args.ssd_mixer != "einsum"):
        p.error("--kan-fused and --ssd-mixer are KM_UNetV3's")
    if not torch.cuda.is_available():
        print("profile_torch_forward: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    if args.batch is None and args.model == "laps":
        args.batch = 1 if args.train else 32
    if args.batch is None:
        args.batch = 16 if args.train or args.model != "km_unet_v3" else 128
    if args.train:
        run = train_step(args.batch, args.dtype, not args.exact, args.model, **options)
        emit({"card": card, "model": args.model, "batch": args.batch, "dtype": args.dtype,
              "train": True, "exact": args.exact, **options})
    else:
        dtype = getattr(torch, args.dtype)
        if args.model == "trajgru":
            model = serve.build_zoo_model("trajgru", device="cuda", dtype=dtype, seed=0)
            frames = torch.rand(args.batch, 5, 128, 128, device="cuda").to(dtype)
        elif args.model == "mamba_unet":
            model = serve.build_zoo_model("mamba_unet", device="cuda", dtype=dtype, seed=0)
            frames = torch.rand(args.batch, 128, 128, 5, device="cuda").to(dtype)
        elif args.model == "laps":
            model = serve.build_km_unet_v3_laps(device="cuda", dtype=dtype, seed=0, **options)
            frames = torch.rand(args.batch, 256, 256, 5, device="cuda").to(dtype)
        else:
            model = serve.build_km_unet_v3_sh(device="cuda", dtype=dtype, seed=0,
                                              dysample_window=not args.exact, **options)
            frames = torch.rand(args.batch, 128, 128, 5, device="cuda").to(dtype)

        def run():
            serve.predict(model, frames)

        for _ in range(2):
            run()
        torch.cuda.synchronize()
        emit({"card": card, "model": args.model, "batch": args.batch, "dtype": args.dtype,
              "exact": args.exact, **options,
              "module_ms": module_times(model, frames, args.iters)})

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    # Layout changes: PyTorch's copies and cuDNN's NCHW <-> NHWC transforms.
    copies = [e for e in kernels if any(w in e.key.lower() for w in (
        "copy", "nchwtonhwc", "nhwctonchw", "tensortransform"))]
    emit({"wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "kernel_launches": sum(e.count for e in kernels),
          "copy_launches": sum(e.count for e in copies),
          "copy_ms": sum(e.self_device_time_total for e in copies) / 1e3,
          "top_kernels": [{"name": e.key[:90], "count": e.count,
                           "ms": e.self_device_time_total / 1e3} for e in top],
          "port_kernels": port_kernels(kernels)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
