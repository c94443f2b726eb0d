"""Streaming nowcast metrics, computed on the device (port of
``kmunet_tpu/metrics/evaluator.py``, the reference's ``SimplifiedEvaluator``).

Per frame, the contingency counts (TP, FN, FP, TN) at each threshold after
the ``value_scale`` integer rescaling, and MAE, MSE, RMSE, PSNR and the
Gaussian-window SSIM; ``Evaluator.done`` aggregates them as the reference
does:

    CSI = TP/(TP+FP+FN)      POD = TP/(TP+FN)     FAR = FP/(TP+FP)
    HSS = 2(TP*TN - FP*FN) / (FP^2 + FN^2 + 2 TP*TN + (FP+FN)(TP+TN))
    RMSE = mean_t sqrt(mean_samples MSE_t)

The reference's uint16 cast truncates; ``floor`` reproduces it, so the
counts are those of the same tensors exactly. LPIPS is real only with
weights (``metrics/lpips.py``); without them it is NaN and
``LPIPS_status`` says why.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from kmunet_tpu_torch.ops.ssim import ssim_valid


def batch_metrics(true: torch.Tensor, pred: torch.Tensor, thresholds: Sequence[float],
                  value_scale: float) -> dict:
    """Per-frame metrics of a (B, T, H, W) batch, on the tensors' device, in
    fp32: 'cont' (n_thr, B, T, 4) int64 [TP, FN, FP, TN] and (B, T) float
    tensors 'mae', 'mse', 'rmse', 'psnr', 'ssim'."""
    pred = pred.float().clamp(0.0, 1.0)
    true = true.float().clamp(0.0, 1.0)
    p_int = torch.floor(pred * value_scale)
    t_int = torch.floor(true * value_scale)

    conts = []
    for thr in thresholds:
        ob = t_int >= thr
        sb = p_int >= thr
        conts.append(torch.stack([(ob & sb).sum(dim=(-2, -1)), (ob & ~sb).sum(dim=(-2, -1)),
                                  (~ob & sb).sum(dim=(-2, -1)), (~ob & ~sb).sum(dim=(-2, -1))],
                                 dim=-1))
    cont = torch.stack(conts)

    ps = pred * value_scale
    ts = true * value_scale
    mae = (ps - ts).abs().mean(dim=(-2, -1))
    mse = ((ps - ts) ** 2).mean(dim=(-2, -1))
    rmse = torch.sqrt(mse)
    psnr = 20.0 * torch.log10(value_scale / torch.sqrt(mse))
    ssim = ssim_valid(ps, ts, data_range=value_scale)
    return {"cont": cont, "mae": mae, "mse": mse, "rmse": rmse, "psnr": psnr, "ssim": ssim}


class Evaluator:
    """Streaming evaluator with the reference's API (evaluate, done, reset);
    ``per_horizon`` breaks the scores down by forecast frame."""

    def __init__(self, seq_len: int, value_scale: float,
                 thresholds: Sequence[float] = (20, 30, 35, 40),
                 lpips_fn: Optional[Callable] = None):
        self.seq_len = seq_len
        self.value_scale = float(value_scale)
        self.thresholds = tuple(thresholds)
        self.lpips_fn = lpips_fn
        self.reset()

    def reset(self):
        self._cont = np.zeros((len(self.thresholds), 4), np.int64)
        self._cont_t = np.zeros((len(self.thresholds), self.seq_len, 4), np.int64)
        self._mse: list[np.ndarray] = []
        self._ssim: list[np.ndarray] = []
        self._mae: list[np.ndarray] = []
        self._psnr: list[np.ndarray] = []
        self._lpips: list[np.ndarray] = []
        self.total = 0

    def evaluate(self, true_batch, pred_batch):
        """Adds a (B, T, H, W) batch (tensors on any device, or arrays)."""
        true = torch.as_tensor(true_batch)
        pred = torch.as_tensor(pred_batch).to(true.device)
        out = batch_metrics(true, pred, self.thresholds, self.value_scale)
        cont = out["cont"].cpu().numpy()  # (n_thr, B, T, 4)
        self._cont += cont.sum(axis=(1, 2))
        self._cont_t += cont.sum(axis=1)
        for key, kept in (("mse", self._mse), ("ssim", self._ssim), ("mae", self._mae),
                          ("psnr", self._psnr)):
            kept.append(out[key].cpu().numpy())
        if self.lpips_fn is not None:
            self._lpips.append(self.lpips_fn(pred, true).cpu().numpy())
        self.total += true.shape[0]

    def done(self) -> dict:
        threshold_metrics = {}
        all_far = []
        # Degenerate denominators give NaN, as the reference's
        # np.seterr(divide/invalid='ignore').
        with np.errstate(divide="ignore", invalid="ignore"):
            for i, thr in enumerate(self.thresholds):
                TP, FN, FP, TN = (np.float64(v) for v in self._cont[i])
                CSI = float(TP / (TP + FP + FN))
                POD = float(TP / (TP + FN))
                HSS = float((2 * (TP * TN - FP * FN))
                            / (FP**2 + FN**2 + 2 * TP * TN + (FP + FN) * (TP + TN)))
                FAR = float(FP / (TP + FP))
                all_far.append(FAR)
                threshold_metrics[thr] = {"CSI": CSI, "POD": POD, "HSS": HSS}

        mse = np.concatenate(self._mse, axis=0)  # (N, T)
        return {
            "threshold_metrics": threshold_metrics,
            "FAR": float(np.mean(all_far)),
            "RMSE": float(np.mean(np.sqrt(np.mean(mse, axis=0)))),
            "SSIM": float(np.mean(np.concatenate(self._ssim, axis=0))),
            "LPIPS": float(np.mean(np.concatenate(self._lpips))) if self._lpips else float("nan"),
            "LPIPS_status": (
                "ok" if self.lpips_fn is not None
                else "needs weights (--data.lpips_weights=<npz>, see metrics/lpips.py)"
            ),
        }

    def per_horizon(self) -> dict:
        """CSI, POD and FAR per output frame at each threshold, and RMSE and
        SSIM per output frame."""
        out: dict = {"thresholds": {}}
        with np.errstate(divide="ignore", invalid="ignore"):
            for i, thr in enumerate(self.thresholds):
                TP, FN, FP, TN = (self._cont_t[i, :, j].astype(np.float64) for j in range(4))
                out["thresholds"][thr] = {
                    "CSI": (TP / (TP + FP + FN)).tolist(),
                    "POD": (TP / (TP + FN)).tolist(),
                    "FAR": (FP / (TP + FP)).tolist(),
                }
        if self._mse:
            out["RMSE"] = np.sqrt(np.concatenate(self._mse, axis=0).mean(axis=0)).tolist()
        if self._ssim:
            out["SSIM"] = np.concatenate(self._ssim, axis=0).mean(axis=0).tolist()
        return out
