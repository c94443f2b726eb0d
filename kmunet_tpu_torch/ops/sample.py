"""Bilinear resampling (port of ``kmunet_tpu/ops/sample.py``).

``bilinear_gather`` is the NHWC gather at pixel coordinates that the
deformable conv runs through, and ``grid_sample_bilinear`` its
``F.grid_sample``-style front: on a CUDA tensor the K5 kernel
(``kernels/bilinear.py``), on a CPU tensor its plain version.
``bilinear_gather_grouped`` samples each channel group at its own
coordinates, DySample's exact path: K4 on a CUDA tensor.
``bilinear_gather_multiview`` samples one source at G coordinate sets,
TrajGRU's warp: K7 on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kmunet_tpu_torch.kernels.bilinear import (
    bilinear_gather,
    bilinear_gather_grouped,
    bilinear_gather_grouped_plain,
    bilinear_gather_multiview,
    bilinear_gather_multiview_plain,
    bilinear_gather_plain,
)
from kmunet_tpu_torch.parallel.halo import all_gather_rows, halo_rows, row_axis, row_range

__all__ = [
    "bilinear_gather",
    "bilinear_gather_grouped",
    "bilinear_gather_grouped_plain",
    "bilinear_gather_multiview",
    "bilinear_gather_multiview_plain",
    "bilinear_gather_plain",
    "dysample_window_upsample",
    "grid_sample_bilinear",
    "resize_bilinear",
]


def resize_bilinear(img: torch.Tensor, size, align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of NCHW images with ``F.interpolate`` semantics, as two
    separable interpolation matrices ``R[o, i] = max(0, 1 - |coord[o] - i|)``
    built in fp32.

    On sharded rows (``row_axis()``, ``parallel/halo.py``) ``img`` is
    this rank's block of rows and ``size`` the global output size: the
    source's rows are gathered from every rank (``all_gather_rows``) and
    this rank's block of output rows is taken from the global matrix."""
    B, C, H, W = img.shape
    Ho, Wo = size
    rows = (0, Ho)
    axis = row_axis()
    if axis is not None:
        if (H * axis.size, W) == (Ho, Wo):
            return img
        img = all_gather_rows(img, axis)
        H = img.shape[2]
        rows = row_range(axis, Ho // axis.size)
    if (H, W) == (Ho, Wo):
        return img
    kw = dict(dtype=torch.float32, device=img.device)
    if align_corners:
        ys = torch.arange(Ho, **kw) * ((H - 1) / max(Ho - 1, 1))
        xs = torch.arange(Wo, **kw) * ((W - 1) / max(Wo - 1, 1))
    else:
        ys = ((torch.arange(Ho, **kw) + 0.5) * (H / Ho) - 0.5).clamp(0, H - 1)
        xs = ((torch.arange(Wo, **kw) + 0.5) * (W / Wo) - 0.5).clamp(0, W - 1)
    ry = (1.0 - (ys[rows[0]:rows[1], None] - torch.arange(H, **kw)[None]).abs()).clamp_min(0.0)
    rx = (1.0 - (xs[:, None] - torch.arange(W, **kw)[None]).abs()).clamp_min(0.0)
    t = torch.einsum("oh,bchw->bcow", ry.to(img.dtype), img)
    return torch.einsum("pw,bcow->bcop", rx.to(img.dtype), t)


def dysample_window_upsample(x: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor,
                             radius: int = 2) -> torch.Tensor:
    """DySample upsampling as (2r+1)^2 dense shifted multiply-adds (NCHW).

    ``x`` (B, C, h, w); ``ex``, ``ey`` (B, G, s, s, h, w): output pixel
    (s*i+di, s*j+dj) of channel group g samples the source at
    (i + ey, j + ex). The absolute coordinate is clamped to the image first
    (border padding), then the residual to (-r + 1e-3, r - 1e-3), so the two
    taps of each axis stay in the window; each tap weighs
    relu(1 - |e - d|). Returns (B, C, s*h, s*w).

    On sharded rows (``row_axis()``, ``parallel/halo.py``) ``x`` and
    the offsets are this rank's block of rows: the rows are numbered and
    clamped in the global image, and the r rows above and below the block
    come from the neighbours (``halo_rows``, the edge row repeated past the
    global edges).
    """
    B, C, h, w = x.shape
    G, s = ex.shape[1], ex.shape[2]
    cg = C // G
    r = int(radius)
    eps = 1e-3
    axis = row_axis()
    row0, _ = row_range(axis, h)
    H = h if axis is None else h * axis.size
    ii = torch.arange(row0, row0 + h, dtype=torch.float32, device=x.device)
    ii = ii.view(1, 1, 1, 1, h, 1)
    jj = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, 1, 1, 1, w)
    ey = ((ii + ey.float()).clamp(0, H - 1) - ii).clamp(-r + eps, r - eps)
    ex = ((jj + ex.float()).clamp(0, w - 1) - jj).clamp(-r + eps, r - eps)
    if axis is None:
        xp = F.pad(x, (r, r, r, r), mode="replicate")
    else:
        xp = F.pad(halo_rows(x, axis, r, r, mode="replicate"), (r, r, 0, 0), mode="replicate")
    subs = []
    for di in range(s):
        for dj in range(s):
            eyd = ey[:, :, di, dj]  # (B, G, h, w)
            exd = ex[:, :, di, dj]
            acc = None
            for dy in range(-r, r + 1):
                wy = (1.0 - (eyd - dy).abs()).clamp_min(0.0)
                for dx in range(-r, r + 1):
                    wgt = wy * (1.0 - (exd - dx).abs()).clamp_min(0.0)
                    # channel c = g*cg + k takes group g's weight
                    wgt = wgt.to(x.dtype).repeat_interleave(cg, dim=1)
                    term = wgt * xp[:, :, r + dy:r + dy + h, r + dx:r + dx + w]
                    acc = term if acc is None else acc + term
            subs.append(acc)
    out = torch.stack(subs).view(s, s, B, C, h, w)
    return out.permute(2, 3, 4, 0, 5, 1).reshape(B, C, s * h, s * w)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                         padding_mode: str = "border") -> torch.Tensor:
    """``F.grid_sample``-compatible bilinear sampling of NHWC ``img``
    (B, H, W, C) at ``grid`` (B, Ho, Wo, 2), normalised [-1, 1] coordinates
    with ``grid[..., 0]`` along W; returns (B, Ho, Wo, C) through
    ``bilinear_gather``. With ``align_corners`` -1 and 1 are the outer pixel
    centres, else the outer pixel edges. Border mode clamps the pixel
    coordinates to the image first, as torch does."""
    B, H, W, _ = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (W - 1)
        y = (gy + 1.0) * 0.5 * (H - 1)
    else:
        x = ((gx + 1.0) * W - 1.0) * 0.5
        y = ((gy + 1.0) * H - 1.0) * 0.5
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    return bilinear_gather(img, x.float().contiguous(), y.float().contiguous(),
                           padding_mode=padding_mode)
