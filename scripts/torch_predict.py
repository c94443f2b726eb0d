#!/usr/bin/env python
"""The port's inference CLI (scripts/predict.py on ``kmunet_tpu_torch``, on
the card): checkpoint -> predicted frame stacks, no ground truth.

Restores a checkpoint of the port (``kmunet_tpu_torch/train/checkpoint.py``),
runs the model in eval mode over the test split's *input* frames and writes
``predictions.npz`` with the JAX script's keys: ``pred`` (N, out_frames, H,
W) float32 clipped to [0, 1], ``checkpoint_step``, ``in_frames`` and
``model``; ``--vis=N`` adds radar-colormap PNG strips of the first N
batches' first sample (``utils.vis.vis_res``; matplotlib, which the card's
machine lacks).

    python3 scripts/torch_predict.py --ckpt=<checkpoint dir> \\
        [--which=best|latest] [--config=shanghai|laps|synthetic] \\
        [--out=outputs/predict] [--vis=N] [--device=cpu] [any --a.b=c override]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kmunet_tpu_torch.configs import laps_km_unet, parse_overrides, shanghai_km_unet  # noqa: E402


def main(argv=None) -> str:
    """Runs the CLI on ``argv`` (default ``sys.argv[1:]``); returns the path
    of ``predictions.npz``."""
    ckpt_dir, which, config_name, out, vis_n, device = None, "best", "shanghai", \
        "outputs/predict", 0, None
    rest = []
    for a in sys.argv[1:] if argv is None else argv:
        if a.startswith("--ckpt="):
            ckpt_dir = a.split("=", 1)[1]
        elif a.startswith("--which="):
            which = a.split("=", 1)[1]
        elif a.startswith("--config="):
            config_name = a.split("=", 1)[1]
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--vis="):
            vis_n = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not ckpt_dir:
        sys.exit("usage: torch_predict.py --ckpt=<checkpoint dir> [--which=best|latest]"
                 " [--out=dir] [--vis=N] [--device=cpu]")
    if which not in ("best", "latest"):
        sys.exit(f"--which={which}: expected 'best' or 'latest'")

    cfg = laps_km_unet() if config_name == "laps" else shanghai_km_unet()
    if config_name == "synthetic":
        cfg.data.name = "synthetic"
    parse_overrides(cfg, rest)
    if cfg.data.path is None and cfg.data.name == "shanghai":
        print("no --data.path given; falling back to synthetic data")
        cfg.data.name = "synthetic"

    from kmunet_tpu_torch.data import DataLoader
    from kmunet_tpu_torch.serve import resolve_device
    from kmunet_tpu_torch.train.checkpoint import CheckpointManager
    from kmunet_tpu_torch.train.engine import (_model_layout, _to_btHW, build_datasets,
                                               build_model, build_optimizer, init_state)

    device = resolve_device(device)
    _, _, test_ds = build_datasets(cfg)
    loader = DataLoader(test_ds, cfg.data.batch_size, shuffle=False, seed=cfg.train.seed,
                        num_workers=cfg.data.num_workers, device=device)
    if len(loader) == 0:
        sys.exit(f"test split ({len(test_ds)}) smaller than batch ({cfg.data.batch_size})")

    model = build_model(cfg)
    tx = build_optimizer(cfg, steps_per_epoch=1)
    state = init_state(cfg, model, tx, seed=cfg.train.seed, device=device)
    mgr = CheckpointManager(ckpt_dir)
    step, state = mgr.restore_best(state) if which == "best" else mgr.restore_latest(state)
    if state is None:
        sys.exit(f"no checkpoint in {ckpt_dir}")
    print(f"restored checkpoint step {step} ({which})")

    layout = _model_layout(cfg)
    in_f = cfg.data.in_frames
    model.eval()
    os.makedirs(out, exist_ok=True)
    preds = []
    with torch.no_grad():
        for bi, batch in enumerate(loader):
            x = batch[:, :in_f]
            if layout == "stack":
                x = x.permute(0, 2, 3, 1)
            pred = _to_btHW(model(x).float(), layout).clamp(0.0, 1.0).cpu().numpy()
            preds.append(pred)
            if vis_n and bi < vis_n:
                from kmunet_tpu_torch.utils.vis import vis_res

                vis_res(pred[0], None, batch[0, :in_f].float().cpu().numpy(),
                        os.path.join(out, "vis", f"batch_{bi}_sample_0"))
    pred = np.concatenate(preds).astype(np.float32)
    path = os.path.join(out, "predictions.npz")
    np.savez_compressed(path, pred=pred, checkpoint_step=int(step), in_frames=in_f,
                        model=cfg.model.name)
    print(f"wrote {pred.shape} predictions -> {path}")
    return path


if __name__ == "__main__":
    main()
