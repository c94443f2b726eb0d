#!/usr/bin/env python
"""The port's train_LAPS.py (the JAX package's scripts/train_laps.py on
``kmunet_tpu_torch``, on the card).

The reference recipe (train_LAPS.py): KM_UNetV3's LAPS variant (no DAGEM
bridge, bilinear upsampling), 5 -> 3 frames of sliding 8-frame windows,
thresholds 0.1/0.3/0.5/0.7/0.8 on normalized values, the scatter metrics'
CSV.

    python3 scripts/torch_train_laps.py --data.path=/path/laps.h5 [any --a.b=c override]

The LAPS file needs h5py and the PNG strips matplotlib
(``--train.vis_batches=0`` writes none).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch.configs import laps_km_unet, parse_overrides  # noqa: E402
from kmunet_tpu_torch.train.engine import train_and_evaluate  # noqa: E402


def main():
    cfg = laps_km_unet()
    cfg.train.ckpt_dir = "outputs/torch/checkpoints/laps"
    cfg.train.out_dir = "outputs/torch/laps"  # PNG strips and scatter_metrics.csv
    parse_overrides(cfg, sys.argv[1:])
    if cfg.data.path is None and cfg.data.name == "laps":
        print("no --data.path given; falling back to synthetic data")
        cfg.data.name = "synthetic"
    results = train_and_evaluate(cfg, log_csv="outputs/torch/laps_epochs.csv")
    print({k: v for k, v in results.items() if k != "history"})


if __name__ == "__main__":
    main()
