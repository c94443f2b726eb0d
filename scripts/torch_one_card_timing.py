#!/usr/bin/env python3
"""The port's one-card KM_UNetV3-SH forward and train step times, taken as
``chip_smoke.py``'s timing phase takes them (CUDA events around
back-to-back calls after warm-up: what a caller waits, host issue
included, PyTorch's default TF32 settings), for the ``kmunet_tpu_torch`` of
the checkout at ``--root``: two checkouts run in turns in one call compare
two trees on one card.

    python3 scripts/torch_one_card_timing.py [--root DIR] [--iters 5]

Prints the card's line (``nvidia-smi`` name and power limit) and one JSON
line: the forward ms at B=128 bf16 (128^2, 5 -> 20 frames) on DySample's
window and exact paths, and the train step ms at B=16 bf16 (the SH recipe,
seq_len 25) on both, each the mean over ``--iters`` calls. Needs an NVIDIA
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls, by CUDA events."""
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


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=REPO, help="checkout whose kmunet_tpu_torch is timed")
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_one_card_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import kmunet_tpu_torch
    from kmunet_tpu_torch import serve
    from kmunet_tpu_torch.configs import shanghai_km_unet
    from kmunet_tpu_torch.train import engine

    if not os.path.abspath(kmunet_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"kmunet_tpu_torch came from {kmunet_tpu_torch.__file__}, not {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": args.root, "card": card, "forward_ms": {}, "step_ms": {}}
    for window in (True, False):
        path = "window" if window else "exact"
        model = serve.build_km_unet_v3_sh(device="cuda", dtype=torch.bfloat16, seed=0,
                                          dysample_window=window)
        frames = torch.rand(128, 128, 128, 5, device="cuda").to(torch.bfloat16)
        out["forward_ms"][f"B128_bfloat16_{path}"] = cuda_ms(
            lambda: serve.predict(model, frames), args.iters)
        del model, frames

        cfg = shanghai_km_unet()
        cfg.data.img_size, cfg.data.batch_size, cfg.data.seq_len = 128, 16, 25
        cfg.data.out_frames = cfg.model.num_classes = 20
        cfg.train.compute_dtype = "bfloat16"
        cfg.model.extra["drop_path"] = 0.1  # chip_smoke.py's sh_config
        model = engine.build_model(cfg, dysample_window=window)
        tx = engine.build_optimizer(cfg, steps_per_epoch=100)
        state = engine.init_state(cfg, model, tx, seed=0, device="cuda")
        step = engine.make_train_step(model, engine.build_loss(cfg), tx, cfg)
        batch = torch.rand(16, 25, 128, 128, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        out["step_ms"][f"B16_bfloat16_{path}"] = cuda_ms(lambda: step(state, batch, gen),
                                                         args.iters)
        del model, state, step, batch
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
