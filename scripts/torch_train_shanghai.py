#!/usr/bin/env python
"""The port's train_shanghai.py (the JAX package's scripts/train_shanghai.py
on ``kmunet_tpu_torch``, on the card).

The reference recipe (train_shanghai.py:329-447): KM_UNetV3's SH variant,
5 -> 20 frames at 256^2, AdamW lr 1e-3 wd 0.05, per-epoch cosine (T_max
200, eta_min 5e-4), 120 epochs, HybridLoss alpha 0.7, best-val
checkpoints, the CSI/POD/HSS/FAR/RMSE/SSIM test evaluation.

    python3 scripts/torch_train_shanghai.py --data.path=/path/shanghai.h5 \\
        [--train.epochs=...] [any --a.b=c override]
    python3 scripts/torch_train_shanghai.py --data.name=synthetic --data.img_size=128

The Shanghai file needs h5py and the PNG strips matplotlib
(``--train.vis_batches=0`` writes none).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch.configs import parse_overrides, shanghai_km_unet  # noqa: E402
from kmunet_tpu_torch.train.engine import train_and_evaluate  # noqa: E402


def main():
    cfg = shanghai_km_unet()
    cfg.train.ckpt_dir = "outputs/torch/checkpoints/shanghai"
    cfg.train.out_dir = "outputs/torch/shanghai"  # the first batches' PNG strips
    parse_overrides(cfg, sys.argv[1:])
    if cfg.data.path is None and cfg.data.name == "shanghai":
        print("no --data.path given; falling back to synthetic data")
        cfg.data.name = "synthetic"
    csv_dir = cfg.train.out_dir or "outputs/torch"
    results = train_and_evaluate(cfg, log_csv=os.path.join(csv_dir, "shanghai_epochs.csv"))
    print({k: v for k, v in results.items() if k != "history"})


if __name__ == "__main__":
    main()
