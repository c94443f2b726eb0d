"""K5, the bilinear gather at pixel coordinates (border or zeros padding),
and K6, its backward.

The port's counterparts of ``kmunet_tpu/kernels/bilinear_pallas.py``'s
``gather_bilinear_border`` / ``gather_bilinear_zeros`` (the ``pl.pallas_call``
in ``_forward``) and of their custom VJP's backward ``_backward_impl`` (the
``pl.pallas_call`` of ``_kernel_bwd``). The CUDA kernels are
``csrc/bilinear_gather.cu`` and ``csrc/bilinear_gather_backward.cu``; their
source notes say what bounds them and how they are laid out.

``bilinear_gather`` is what callers use: a ``torch.autograd.Function``
(``BilinearGather``) whose forward is K5 and whose backward is K6 on a CUDA
tensor, and the plain versions of both on a CPU tensor. It dispatches on the
device of its input alone; on a CUDA tensor it launches the kernels or
raises. ``bilinear_gather.launches`` and ``bilinear_gather_backward.launches``
count the kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kmunet_tpu_torch.kernels import build

SOURCE = "bilinear_gather.cu"
BACKWARD_SOURCE = "bilinear_gather_backward.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MODES = ("border", "zeros")


def _check_mode(padding_mode: str) -> None:
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode must be one of {_MODES}, got {padding_mode!r}")


def _coords(x, y, H: int, W: int, zeros: bool):
    """The fractions ``wx``, ``wy`` and the int64 floors ``x0``, ``y0`` of the
    clamped coordinates, computed in at least fp32."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x, y = x.to(ct), y.to(ct)
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
    return x - x0, y - y0, x0.long(), y0.long()


def _tap(yi, xi, H: int, W: int, zeros: bool):
    """Flat index into H*W of the tap at (yi, xi), and in zeros mode whether
    it lies inside the image (None in border mode, where it always does)."""
    if zeros:
        inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        return yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), inside
    return yi.clamp(max=H - 1) * W + xi.clamp(max=W - 1), None


def _clip_vjp(v, lo: float, hi: float):
    """d/dv of ``jnp.clip(v, lo, hi)``, which is ``minimum(maximum(v, lo),
    hi)``: each passes half the cotangent at a tie, so a coordinate exactly
    on the border gets 0.5 of it (``torch.clamp`` passes all of it)."""
    def step(a, b):  # d max(a, b) / da
        return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))

    return step(v, v.new_tensor(lo)) * step(v.new_tensor(hi), v.clamp_min(lo))


def bilinear_gather_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Plain PyTorch version of K5: ``img`` (B, H, W, C) sampled at pixel
    coords ``x`` (along W) and ``y`` (along H), each (B, Ho, Wo) -> (B, Ho, Wo, C).

    The arithmetic of ``kmunet_tpu/ops/sample.py::bilinear_gather_xla``: the
    tap weights are cast to ``img``'s dtype and blended there.
    """
    _check_mode(padding_mode)
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    zeros = padding_mode == "zeros"
    wx, wy, x0, y0 = _coords(x, y, H, W, zeros)
    wx = wx.to(img.dtype)[..., None]
    wy = wy.to(img.dtype)[..., None]
    flat = img.reshape(B, H * W, C)

    def tap(dy, dx):
        idx, inside = _tap(y0 + dy, x0 + dx, H, W, zeros)
        idx = idx.reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        v = torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)
        return v if inside is None else v * inside[..., None].to(img.dtype)

    top = tap(0, 0) * (1.0 - wx) + tap(0, 1) * wx
    bot = tap(1, 0) * (1.0 - wx) + tap(1, 1) * wx
    return top * (1.0 - wy) + bot * wy


def bilinear_gather_backward_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: the VJP of ``bilinear_gather_plain`` for
    the upstream gradient ``g`` (B, Ho, Wo, C); returns (d_img, d_x, d_y) in
    the dtypes of ``img``, ``x`` and ``y``.

    The conventions of the JAX package's custom VJP (``_make_gather_op``):
    ``d_img`` accumulates in (at least) fp32 and is cast at the end; the
    coordinate gradients are taken with respect to the clamped coordinates,
    and in border mode they are 0 where ``x0`` (``y0``) sits on the last
    pixel (here because the far tap duplicates the edge pixel, as in the XLA
    reference; the Pallas kernel masks them) and are then chained through
    the border clamp as ``jnp.clip``'s VJP does (0.5 of the gradient at a
    coordinate exactly on the border). Zeros mode chains nothing: beyond
    [-2, dim+1] every tap is masked.
    """
    _check_mode(padding_mode)
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    zeros = padding_mode == "zeros"
    acc = torch.promote_types(img.dtype, torch.float32)
    wx, wy, x0, y0 = _coords(x, y, H, W, zeros)
    wx = wx.to(acc)[..., None]
    wy = wy.to(acc)[..., None]
    gf = g.to(acc)
    flat = img.to(acc).reshape(B, H * W, C)
    d_flat = torch.zeros_like(flat)
    v = {}
    for dy, dx, w in ((0, 0, (1.0 - wx) * (1.0 - wy)), (0, 1, wx * (1.0 - wy)),
                      (1, 0, (1.0 - wx) * wy), (1, 1, wx * wy)):
        idx, inside = _tap(y0 + dy, x0 + dx, H, W, zeros)
        idx = idx.reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        val = torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)
        part = gf * w
        if inside is not None:
            mask = inside[..., None].to(acc)
            val, part = val * mask, part * mask
        d_flat.scatter_add_(1, idx, part.reshape(B, Ho * Wo, C))
        v[dy, dx] = val
    d_x = (gf * ((v[0, 1] - v[0, 0]) * (1.0 - wy) + (v[1, 1] - v[1, 0]) * wy)).sum(-1)
    d_y = (gf * ((v[1, 0] - v[0, 0]) * (1.0 - wx) + (v[1, 1] - v[0, 1]) * wx)).sum(-1)
    if not zeros:
        d_x = d_x * _clip_vjp(x.to(d_x.dtype), 0.0, W - 1)
        d_y = d_y * _clip_vjp(y.to(d_y.dtype), 0.0, H - 1)
    return d_flat.reshape(B, H, W, C).to(img.dtype), d_x.to(x.dtype), d_y.to(y.dtype)


@functools.cache
def _kernel(source: str, name: str, n_pointers: int) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the library built from ``csrc/<source>``:
    ``n_pointers`` tensor pointers, nine ints, then the stream."""
    fn = getattr(ctypes.CDLL(str(build.build(source).path)), name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def forward_kernel() -> ctypes._CFuncPtr:
    """K5's entry point, built on first use."""
    return _kernel(SOURCE, "kmunet_bilinear_gather", 4)


def backward_kernel() -> ctypes._CFuncPtr:
    """K6's entry point, built on first use."""
    return _kernel(BACKWARD_SOURCE, "kmunet_bilinear_gather_backward", 8)


def _check(img, x, y, padding_mode):
    _check_mode(padding_mode)
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


def _vec(img, *tensors) -> int:
    """Channels per thread: 16 bytes' worth where C and every pointer allow it."""
    wide = 16 // img.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (img, *tensors))
    return wide if img.shape[-1] % wide == 0 and aligned else 1


def _launch(fn, img, *args) -> None:
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: error {err}")


def bilinear_gather_forward(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """The gather without its gradient: (B, Ho, Wo, C) in ``img``'s dtype. A
    CPU ``img`` takes the plain version; a CUDA ``img`` launches K5, which
    takes fp32, bf16 and fp16 images with fp32 coordinates. Its launches
    count on ``bilinear_gather.launches``."""
    if img.device.type == "cpu":
        return bilinear_gather_plain(img, x, y, padding_mode)
    _check(img, x, y, padding_mode)
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    out = torch.empty((B, Ho, Wo, C), dtype=img.dtype, device=img.device)
    _launch(forward_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            B, H, W, C, Ho, Wo, _DTYPE_CODES[img.dtype], int(padding_mode == "zeros"),
            _vec(img))
    bilinear_gather.launches += 1
    return out


def bilinear_gather_backward(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_img, d_x, d_y) of the gather for the upstream gradient ``g``
    (B, Ho, Wo, C) in ``img``'s dtype. A CPU ``img`` takes the plain version;
    a CUDA ``img`` launches K6, which takes fp32, bf16 and fp16 images with
    fp32 coordinates, and returns d_x, d_y in fp32."""
    if img.device.type == "cpu":
        return bilinear_gather_backward_plain(img, x, y, g, padding_mode)
    _check(img, x, y, padding_mode)
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    if g.dtype != img.dtype or g.device != img.device or g.shape != (B, Ho, Wo, C):
        raise ValueError(f"g must be {img.dtype} ({B}, {Ho}, {Wo}, {C}) on {img.device}; "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    d_img32 = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    d_img = d_img32 if img.dtype == torch.float32 else torch.empty_like(img)
    d_x = torch.empty_like(x)
    d_y = torch.empty_like(y)
    _launch(backward_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
            d_img32.data_ptr(), d_img.data_ptr(), d_x.data_ptr(), d_y.data_ptr(),
            B, H, W, C, Ho, Wo, _DTYPE_CODES[img.dtype], int(padding_mode == "zeros"),
            _vec(img, g))
    bilinear_gather_backward.launches += 1
    return d_img, d_x, d_y


class BilinearGather(torch.autograd.Function):
    """The gather with its gradient: K5 forward and K6 backward on a CUDA
    tensor, the plain versions of both on a CPU tensor. Never runs a plain
    version on a CUDA tensor."""

    @staticmethod
    def forward(ctx, img, x, y, padding_mode):
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(img, x, y)
        return bilinear_gather_forward(img, x, y, padding_mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, x, y = ctx.saved_tensors
        d_img, d_x, d_y = bilinear_gather_backward(img, x, y, g.contiguous(), ctx.padding_mode)
        need = ctx.needs_input_grad
        return (d_img if need[0] else None, d_x if need[1] else None,
                d_y if need[2] else None, None)


def bilinear_gather(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Bilinear sample of ``img`` (B, H, W, C) at ``x``, ``y`` (B, Ho, Wo),
    pixel coordinates; returns (B, Ho, Wo, C) in ``img``'s dtype, with its
    gradient to all three inputs.

    A CPU ``img`` takes the plain versions; a CUDA ``img`` launches K5 (and
    K6 in the backward), which take fp32, bf16 and fp16 images and fp32
    coordinates.
    """
    return BilinearGather.apply(img, x, y, padding_mode)


bilinear_gather.launches = 0
bilinear_gather_backward.launches = 0
