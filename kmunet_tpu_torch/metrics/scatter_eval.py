"""The flattened "scatter" evaluation, the reference's second metrics path
(the port's own copy of ``kmunet_tpu/metrics/scatter_eval.py``, numpy on the
host): every prediction and ground truth flattened, binarized per
threshold, and accuracy, HSS, POD, specificity, F1, CSI and FAR taken from
the confusion matrix, with the global RMSE; optionally appended to a CSV.

The reference's quirks are kept:
- HSS is (TP*TN - FN*FP) / ((TP+FN)(FN+TN) + (TP+FP)(FP+TN)), WITHOUT the
  factor of 2 of the Evaluator's HSS.
- SSIM is skimage's on the flattened 1-D vectors: a 7-wide uniform window
  over the scan order, with skimage's constants.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np


def _ssim_1d(x: np.ndarray, y: np.ndarray, data_range: float = 1.0, win: int = 7) -> float:
    """skimage's structural_similarity of 1-D signals: a ``win``-wide
    uniform window, C1 = (0.01 R)^2, C2 = (0.03 R)^2 and the sample
    covariance's n / (n - 1)."""
    kernel = np.ones(win) / win

    def filt(a):
        return np.convolve(a, kernel, mode="valid")

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    cov_norm = win / (win - 1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    return float(s.mean())


def scatter_evaluate(
    gts: np.ndarray,
    preds: np.ndarray,
    thresholds: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.8),
    csv_path: Optional[str] = None,
    ssim_max_elems: int = 2_000_000,
) -> dict:
    """{threshold: {SSIM, FAR, CSI, HSS, POD, specificity, accuracy, F1,
    RMSE}} of ``gts`` and ``preds``, arrays of any shape of normalized
    values; the 1-D SSIM over the first ``ssim_max_elems`` values."""
    gts = np.asarray(gts, np.float64).reshape(-1)
    preds = np.asarray(preds, np.float64).reshape(-1)
    rmse = float(np.sqrt(np.mean((gts - preds) ** 2)))
    n = min(gts.size, ssim_max_elems)
    ssim_val = _ssim_1d(gts[:n], preds[:n])

    results = {}
    for thr in thresholds:
        yp = preds >= thr
        yt = gts >= thr
        TP = float(np.sum(yt & yp))
        TN = float(np.sum(~yt & ~yp))
        FP = float(np.sum(~yt & yp))
        FN = float(np.sum(yt & ~yp))
        total = TP + TN + FP + FN
        accuracy = (TN + TP) / total if total else 0.0
        denom = (TP + FN) * (FN + TN) + (TP + FP) * (FP + TN)
        HSS = (TP * TN - FN * FP) / denom if denom else 0.0
        POD = TP / (TP + FN) if TP + FN else 0.0
        specificity = TN / (TN + FP) if TN + FP else 0.0
        F1 = 2 * TP / (2 * TP + FP + FN) if 2 * TP + FP + FN else 0.0
        CSI = TP / (TP + FP + FN) if TP + FP + FN else 0.0
        FAR = FP / (TP + FP) if TP + FP else 0.0
        row = {"SSIM": ssim_val, "FAR": FAR, "CSI": CSI, "HSS": HSS, "POD": POD,
               "specificity": specificity, "accuracy": accuracy, "F1": F1, "RMSE": rmse}
        results[thr] = row
        if csv_path:
            new = not os.path.exists(csv_path) or os.path.getsize(csv_path) == 0
            with open(csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["Threshold", "SSIM", "FAR", "CSI", "HSS", "POD", "RMSE"])
                w.writerow([thr] + [round(row[k], 4) for k in
                                    ("SSIM", "FAR", "CSI", "HSS", "POD", "RMSE")])
    return results
