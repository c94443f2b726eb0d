"""K5: bilinear gather at pixel coordinates, border or zeros padding.

The port's counterpart of ``kmunet_tpu/kernels/bilinear_pallas.py``'s
``gather_bilinear_border`` / ``gather_bilinear_zeros`` (the ``pl.pallas_call``
in ``_forward``). The CUDA kernel is ``csrc/bilinear_gather.cu``; its source
note says what bounds it and how it is laid out.

``bilinear_gather`` dispatches on the device of its input alone: on a CPU
tensor it runs ``bilinear_gather_plain``, on a CUDA tensor it launches the
kernel or raises. ``bilinear_gather.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kmunet_tpu_torch.kernels import build

SOURCE = "bilinear_gather.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MODES = ("border", "zeros")


def bilinear_gather_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Plain PyTorch version: ``img`` (B, H, W, C) sampled at pixel coords
    ``x`` (along W) and ``y`` (along H), each (B, Ho, Wo) -> (B, Ho, Wo, C).

    The arithmetic of ``kmunet_tpu/ops/sample.py::bilinear_gather_xla``: the
    tap weights are cast to ``img``'s dtype and blended there.
    """
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode must be one of {_MODES}, got {padding_mode!r}")
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    zeros = padding_mode == "zeros"
    x = x.float()
    y = y.float()
    if zeros:
        # Guards only the int conversion: beyond [-2, dim+1] both taps of an
        # axis are out of range already.
        x = x.clamp(-2.0, W + 1.0)
        y = y.clamp(-2.0, H + 1.0)
    else:
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(img.dtype)[..., None]
    wy = (y - y0).to(img.dtype)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = img.reshape(B, H * W, C)

    def tap(yi, xi):
        if zeros:
            inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            yi, xi = yi.clamp(0, H - 1), xi.clamp(0, W - 1)
        else:
            yi, xi = yi.clamp(max=H - 1), xi.clamp(max=W - 1)
        idx = (yi * W + xi).reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        v = torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)
        return v * inside[..., None].to(img.dtype) if zeros else v

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build(SOURCE).path))
    fn = lib.kmunet_bilinear_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(img, x, y, padding_mode):
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode must be one of {_MODES}, got {padding_mode!r}")
    if not img.is_cuda:
        raise ValueError(f"the CUDA gather needs a CUDA tensor, got {img.device}")
    if img.dtype not in _DTYPE_CODES:
        raise TypeError(f"img dtype {img.dtype} not in {list(_DTYPE_CODES)}")
    if img.dim() != 4 or x.dim() != 3 or x.shape != y.shape or x.shape[0] != img.shape[0]:
        raise ValueError(f"want img (B,H,W,C), x/y (B,Ho,Wo); got {img.shape}, {x.shape}, {y.shape}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"{name} on {t.device}, img on {img.device}")
    for name, t in (("img", img), ("x", x), ("y", y)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(img.numel(), x.shape.numel() * img.shape[-1]) >= 2**30:
        raise ValueError("the kernel takes images and outputs of fewer than 2**30 elements")


def bilinear_gather(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Bilinear sample of ``img`` (B, H, W, C) at ``x``, ``y`` (B, Ho, Wo),
    float32 pixel coordinates; returns (B, Ho, Wo, C) in ``img``'s dtype.

    A CPU ``img`` takes the plain version; a CUDA ``img`` launches the
    kernel, which takes fp32, bf16 and fp16 images.
    """
    if img.device.type == "cpu":
        return bilinear_gather_plain(img, x, y, padding_mode)
    _check(img, x, y, padding_mode)
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    wide = 16 // img.element_size()
    vec = wide if C % wide == 0 and img.data_ptr() % 16 == 0 else 1
    out = torch.empty((B, Ho, Wo, C), dtype=img.dtype, device=img.device)
    fn = _library().kmunet_bilinear_gather
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                 B, H, W, C, Ho, Wo, _DTYPE_CODES[img.dtype],
                 int(padding_mode == "zeros"), vec, stream)
    if err != 0:
        raise RuntimeError(f"bilinear_gather kernel launch failed: error {err}")
    bilinear_gather.launches += 1
    return out


bilinear_gather.launches = 0
