#!/usr/bin/env python
"""The port's train_baseline.py (the JAX package's scripts/train_baseline.py
on ``kmunet_tpu_torch``, on the card): one trainer for the zoo's baselines
under each model's reference recipe (``kmunet_tpu_torch/train/recipes.py``).

    python3 scripts/torch_train_baseline.py --model.name=smaat_unet --recipe=pic
    python3 scripts/torch_train_baseline.py --model.name=swin_unet --recipe=nc \\
        --data.path=/path/to/laps [--train.epochs=2] [any --a.b=c override]

    --recipe=pic  Shanghai 256^2, 5 in / 20 out (``shanghai_km_unet()``)
    --recipe=nc   LAPS 256^2, 5 in / 3 out (``laps_km_unet()``)

The overrides are applied after the recipe, so ``--train.lr=1e-4`` or
``--train.epochs=2`` win. With no ``--data.path`` the run trains on
synthetic data. ``--device=cpu`` runs on the CPU; the default is the card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch.configs import laps_km_unet, parse_overrides, shanghai_km_unet  # noqa: E402
from kmunet_tpu_torch.train.engine import train_and_evaluate  # noqa: E402
from kmunet_tpu_torch.train.recipes import apply_recipe  # noqa: E402


def main(argv=None):
    """Trains ``--model.name`` (default smaat_unet) under ``--recipe``
    (default pic) and returns ``train_and_evaluate``'s results."""
    argv = list(sys.argv[1:] if argv is None else argv)
    recipe, model, device, rest = "pic", "smaat_unet", None, []
    for a in argv:
        if a.startswith("--recipe="):
            recipe = a.split("=", 1)[1]
        elif a.startswith("--model.name="):
            model = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if recipe not in ("pic", "nc"):
        raise SystemExit(f"--recipe must be pic or nc, got {recipe!r}")
    cfg = shanghai_km_unet() if recipe == "pic" else laps_km_unet()
    apply_recipe(cfg, model, recipe)
    parse_overrides(cfg, rest)
    cfg.model.num_classes = cfg.data.out_frames
    if cfg.data.path is None:
        print("no --data.path given; falling back to synthetic data")
        cfg.data.name = "synthetic"
    results = train_and_evaluate(cfg, device=device)
    if int(os.environ.get("RANK", 0)) == 0:  # under torchrun, rank 0 reports
        print({k: v for k, v in results.items() if k != "history"})
    return results


if __name__ == "__main__":
    main()
