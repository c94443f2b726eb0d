"""Single-level 2D Haar DWT (port of ``kmunet_tpu/ops/dwt.py``)."""

from __future__ import annotations

import torch


def haar_dwt2d(x: torch.Tensor, quirk_edge_zero: bool = True, last_rows: bool = True):
    """Haar DWT of an NCHW tensor with even H and W -> (LL, LH, HL, HH),
    each (B, C, H/2, W/2).

    The 2x2 stride-2 filter bank with lo = (a+b)/sqrt2, hi = (a-b)/sqrt2,
    first along H then along W: LH is low along H and high along W.
    ``quirk_edge_zero`` keeps the reference's off-by-one (its high-pass band
    matrix has an all-zero last row): LH's last column, HL's last row and
    both for HH are zero. On a block of the image's rows (sharded rows,
    ``parallel/halo.py``) the transform is the block's own, and the row
    quirk is the global last row's: ``last_rows`` says whether the block
    holds it.
    """
    B, C, H, W = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"haar_dwt2d needs even spatial dims, got {(H, W)}")
    a = x[:, :, 0::2, 0::2]
    b = x[:, :, 0::2, 1::2]
    c = x[:, :, 1::2, 0::2]
    d = x[:, :, 1::2, 1::2]
    LL = (a + b + c + d) * 0.5
    LH = (a - b + c - d) * 0.5
    HL = (a + b - c - d) * 0.5
    HH = (a - b - c + d) * 0.5
    if quirk_edge_zero:
        LH[..., -1] = 0
        HH[..., -1] = 0
        if last_rows:
            HL[..., -1, :] = 0
            HH[..., -1, :] = 0
    return LL, LH, HL, HH
