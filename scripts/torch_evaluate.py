#!/usr/bin/env python
"""The port's checkpoint evaluation (the JAX package's scripts/evaluate.py on
``kmunet_tpu_torch``, on the card).

The reference reloads the saved best model and runs test(): the streaming
CSI/POD/HSS/FAR/RMSE/SSIM/LPIPS evaluation and the prediction/gt/input PNG
strips (train_shanghai.py:437-441, 218-283). This is that flow on a
checkpoint of the port (``kmunet_tpu_torch/train/checkpoint.py``), without
the training run in front of it:

    python3 scripts/torch_evaluate.py --ckpt=outputs/torch/checkpoints/shanghai \\
        [--which=latest] [--config=shanghai|laps|synthetic] \\
        [--data.path=/path/shanghai.h5] [any --a.b=c override]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch.configs import laps_km_unet, parse_overrides, shanghai_km_unet  # noqa: E402
from kmunet_tpu_torch.train.engine import evaluate_checkpoint  # noqa: E402


def main():
    ckpt_dir = None
    which = "best"
    config_name = "shanghai"
    rest = []
    for a in sys.argv[1:]:
        if a.startswith("--ckpt="):
            ckpt_dir = a.split("=", 1)[1]
        elif a.startswith("--which="):
            which = a.split("=", 1)[1]
        elif a.startswith("--config="):
            config_name = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not ckpt_dir:
        sys.exit("usage: torch_evaluate.py --ckpt=<checkpoint dir> [--which=best|latest]")
    if which not in ("best", "latest"):
        sys.exit(f"--which={which}: expected 'best' or 'latest'")

    cfg = laps_km_unet() if config_name == "laps" else shanghai_km_unet()
    if config_name == "synthetic":
        cfg.data.name = "synthetic"
    cfg.train.out_dir = cfg.train.out_dir or "outputs/torch/evaluate"
    parse_overrides(cfg, rest)
    if cfg.data.path is None and cfg.data.name == "shanghai":
        print("no --data.path given; falling back to synthetic data")
        cfg.data.name = "synthetic"
    results = evaluate_checkpoint(cfg, ckpt_dir, which=which)
    if int(os.environ.get("RANK", 0)) == 0:  # under torchrun, rank 0 reports
        print(results)


if __name__ == "__main__":
    main()
