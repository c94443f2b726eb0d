"""K5, the bilinear gather at pixel coordinates (border or zeros padding),
K4, its grouped form (one coordinate set per channel group), K7, its
multiview form (one source sampled at G coordinate sets), and K6, the
backward of all three.

The port's counterparts of ``kmunet_tpu/kernels/bilinear_pallas.py``'s
``gather_bilinear_border`` / ``gather_bilinear_zeros`` (the ``pl.pallas_call``
in ``_forward``), ``gather_bilinear_grouped`` and ``gather_bilinear_multiview``
(the ``pl.pallas_call`` in ``_forward_grouped``, ``shared=False`` and
``shared=True``) and of their custom VJP's backward ``_backward_impl`` (the
``pl.pallas_call`` of ``_kernel_bwd``, ``shared=False`` and ``shared=True``).
The CUDA kernels are ``csrc/bilinear_gather.cu`` (K5 and K4, one kernel with
a group count), ``csrc/multiview_gather.cu`` (K7: each warp reckons a chunk
of (output pixel, view) entries once, then blends them with a lane per
16-byte channel vector; its chunk is ``multiview_chunk``'s) and
``csrc/bilinear_gather_backward.cu`` (K6 for all three), which take their
padding rules and dtype conversions from ``csrc/gather_taps.cuh``; their
source notes say what bounds them and how they are laid out.

``bilinear_gather``, ``bilinear_gather_grouped`` and
``bilinear_gather_multiview`` are what callers use: autograd functions
(``BilinearGather``, ``BilinearGatherGrouped``, ``BilinearGatherMultiview``)
whose forward is K5 (K4, K7) and whose backward is K6 on a CUDA tensor, and
the plain versions of both on a CPU tensor. They dispatch on the device of
their input alone; on a CUDA tensor they launch the kernels or raise. Each
launcher counts its kernel's launches: ``bilinear_gather.launches``,
``bilinear_gather_backward.launches``, ``bilinear_gather_grouped.launches``,
``bilinear_gather_grouped_backward.launches``,
``bilinear_gather_multiview.launches`` and
``bilinear_gather_multiview_backward.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kmunet_tpu_torch.kernels import build, sm_count

SOURCE = "bilinear_gather.cu"
MULTIVIEW_SOURCE = "multiview_gather.cu"
BACKWARD_SOURCE = "bilinear_gather_backward.cu"
# The warps per SM that K7's chunks of (output pixel, view) entries aim to
# keep busy (``multiview_chunk``).
MULTIVIEW_WARPS_PER_SM = 16
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


def _fold_groups(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*G, H, W, C/G): channel block g of image b is image
    b*G + g."""
    B, H, W, C = t.shape
    return t.reshape(B, H, W, G, C // G).permute(0, 3, 1, 2, 4).reshape(B * G, H, W, C // G)


def _unfold_groups(t: torch.Tensor, B: int) -> torch.Tensor:
    """The inverse of ``_fold_groups``: (B*G, H, W, Cg) -> (B, H, W, G*Cg)."""
    BG, H, W, Cg = t.shape
    G = BG // B
    return t.reshape(B, G, H, W, Cg).permute(0, 2, 3, 1, 4).reshape(B, H, W, G * Cg)


def _check_views(img, x, y) -> None:
    if img.dim() != 4 or x.dim() != 4 or x.shape != y.shape or x.shape[0] != img.shape[0]:
        raise ValueError(f"want img (B,H,W,C), x/y (B,G,Ho,Wo); got {tuple(img.shape)}, "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")


def _check_groups(img, x, y) -> None:
    _check_views(img, x, y)
    if img.shape[-1] % x.shape[1]:
        raise ValueError(f"C={img.shape[-1]} is not a multiple of G={x.shape[1]}")


def bilinear_gather_grouped_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Plain PyTorch version of K4: channel block g of ``img`` (B, H, W, C),
    C/G channels, sampled at its own pixel coords ``x[:, g]``, ``y[:, g]``
    ((B, G, Ho, Wo)) -> (B, Ho, Wo, C).

    What ``kmunet_tpu/ops/sample.py::bilinear_gather_grouped_xla`` computes,
    the same way: the groups folded into the batch, then
    ``bilinear_gather_plain`` (tap weights cast to ``img``'s dtype).
    """
    _check_groups(img, x, y)
    B, G, Ho, Wo = x.shape
    out = bilinear_gather_plain(_fold_groups(img, G), x.reshape(B * G, Ho, Wo),
                                y.reshape(B * G, Ho, Wo), padding_mode)
    return _unfold_groups(out, B)


def bilinear_gather_grouped_backward_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 for K4: the VJP of
    ``bilinear_gather_grouped_plain`` for the upstream gradient ``g``
    (B, Ho, Wo, C); returns (d_img (B, H, W, C), d_x, d_y (B, G, Ho, Wo)) in
    the dtypes of ``img``, ``x`` and ``y``, with the conventions of
    ``bilinear_gather_backward_plain`` (d_img accumulated in fp32; d_x of
    group g sums over group g's channels only)."""
    _check_groups(img, x, y)
    B, G, Ho, Wo = x.shape
    d_img, d_x, d_y = bilinear_gather_backward_plain(
        _fold_groups(img, G), x.reshape(B * G, Ho, Wo), y.reshape(B * G, Ho, Wo),
        _fold_groups(g, G), padding_mode)
    return _unfold_groups(d_img, B), d_x.reshape(B, G, Ho, Wo), d_y.reshape(B, G, Ho, Wo)


def _fold_views(img: torch.Tensor, G: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*G, H, W, C): the source broadcast into the batch,
    image b*G + g being image b."""
    B, H, W, C = img.shape
    return img[:, None].expand(B, G, H, W, C).reshape(B * G, H, W, C)


def bilinear_gather_multiview_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Plain PyTorch version of K7: all of ``img`` (B, H, W, C) sampled at
    each of G coordinate sets ``x[:, g]``, ``y[:, g]`` ((B, G, Ho, Wo)) ->
    (B, Ho, Wo, G*C), view g in channel block g.

    What ``kmunet_tpu/ops/sample.py::bilinear_gather_multiview_xla`` computes,
    the same way: the source broadcast into the batch, then
    ``bilinear_gather_plain``.
    """
    _check_views(img, x, y)
    B, G, Ho, Wo = x.shape
    out = bilinear_gather_plain(_fold_views(img, G), x.reshape(B * G, Ho, Wo),
                                y.reshape(B * G, Ho, Wo), padding_mode)
    return _unfold_groups(out, B)


def bilinear_gather_multiview_backward_plain(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 for K7 (``shared=True``): the VJP of
    ``bilinear_gather_multiview_plain`` for the upstream gradient ``g``
    (B, Ho, Wo, G*C); returns (d_img (B, H, W, C), d_x, d_y (B, G, Ho, Wo))
    in the dtypes of ``img``, ``x`` and ``y``, with the conventions of
    ``bilinear_gather_backward_plain``: ``bilinear_gather_backward_plain`` on
    the folded views, d_img summed over the views in (at least) fp32 and cast
    at the end; d_x of view g sums over all C channels of its block."""
    _check_views(img, x, y)
    B, G, Ho, Wo = x.shape
    acc = torch.promote_types(img.dtype, torch.float32)
    d_img, d_x, d_y = bilinear_gather_backward_plain(
        _fold_views(img.to(acc), G), x.reshape(B * G, Ho, Wo), y.reshape(B * G, Ho, Wo),
        _fold_groups(g.to(acc), G), padding_mode)
    d_img = d_img.reshape(B, G, *img.shape[1:]).sum(1)
    return d_img.to(img.dtype), d_x.reshape(B, G, Ho, Wo), d_y.reshape(B, G, Ho, Wo)


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, built on first use."""
    return ctypes.CDLL(str(build.build(source).path))


@functools.cache
def _kernel(source: str, name: str, n_pointers: int, n_ints: int) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the library built from ``csrc/<source>``:
    ``n_pointers`` tensor pointers, ``n_ints`` ints, then the stream."""
    fn = getattr(_library(source), name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def workspace_kernel() -> ctypes._CFuncPtr:
    """K6's workspace size in bytes for (B, H, W, C, G, Ho, Wo, shared), -1
    for shapes K6 refuses; built on first use (from K6's source)."""
    fn = _library(BACKWARD_SOURCE).kmunet_bilinear_gather_backward_workspace
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_longlong
    return fn


def forward_kernel() -> ctypes._CFuncPtr:
    """K5's entry point, built on first use."""
    return _kernel(SOURCE, "kmunet_bilinear_gather", 4, 9)


def backward_kernel() -> ctypes._CFuncPtr:
    """K6's entry point, built on first use."""
    return _kernel(BACKWARD_SOURCE, "kmunet_bilinear_gather_backward", 8, 9)


def grouped_kernel() -> ctypes._CFuncPtr:
    """K4's entry point, built on first use (from K5's source)."""
    return _kernel(SOURCE, "kmunet_bilinear_gather_grouped", 4, 10)


def grouped_backward_kernel() -> ctypes._CFuncPtr:
    """K6's grouped entry point, built on first use (from K6's source)."""
    return _kernel(BACKWARD_SOURCE, "kmunet_bilinear_gather_grouped_backward", 8, 10)


def multiview_kernel() -> ctypes._CFuncPtr:
    """K7's entry point, built on first use."""
    return _kernel(MULTIVIEW_SOURCE, "kmunet_bilinear_gather_multiview", 4, 11)


def multiview_chunk(B: int, G: int, Ho: int, Wo: int, sms: int) -> int:
    """K7's chunk on a card of ``sms`` SMs: the (output pixel, view) entries
    that a warp reckons and then blends at a time, as many as leave
    ``MULTIVIEW_WARPS_PER_SM`` warps per SM a chunk each, up to 32 (a lane
    per entry): 32 at TrajGRU's 32^2 levels and the bridge. 0 where that
    leaves a chunk one entry: the kernel then takes one (entry, channel
    vector) pair a thread, each reckoning its entry, as at TrajGRU's 4^2
    levels, where latency and not arithmetic sets the time."""
    chunk = min(32, B * G * Ho * Wo // (MULTIVIEW_WARPS_PER_SM * sms))
    return chunk if chunk >= 2 else 0


def multiview_backward_kernel() -> ctypes._CFuncPtr:
    """K6's shared-source entry point, built on first use (from K6's source)."""
    return _kernel(BACKWARD_SOURCE, "kmunet_bilinear_gather_multiview_backward", 8, 10)


def _check(img, x, y, padding_mode, grouped: bool = False, views: bool = False):
    _check_mode(padding_mode)
    if not img.is_cuda:
        raise ValueError(f"the CUDA gather needs a CUDA tensor, got {img.device}")
    if img.dtype not in _DTYPE_CODES:
        raise TypeError(f"img dtype {img.dtype} not in {list(_DTYPE_CODES)}")
    if grouped:
        _check_groups(img, x, y)
    elif views:
        _check_views(img, x, y)
    elif img.dim() != 4 or x.dim() != 3 or x.shape != y.shape or x.shape[0] != img.shape[0]:
        raise ValueError(f"want img (B,H,W,C), x/y (B,Ho,Wo); got {img.shape}, {x.shape}, {y.shape}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"{name} on {t.device}, img on {img.device}")
    for name, t in (("img", img), ("x", x), ("y", y)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The kernels index in int32. DySample's dec3 output at B=128 (128^2, C=64)
    # is 134 M elements, inside the limit.
    out_channels = img.shape[-1] * (x.shape[1] if views else 1)
    if max(img.numel(), x.shape[0] * x.shape[-2] * x.shape[-1] * out_channels) >= 2**30:
        raise ValueError("the kernel takes images and outputs of fewer than 2**30 elements")


def _check_grad(img, x, g, views: bool = False):
    B, C = img.shape[0], img.shape[-1] * (x.shape[1] if views else 1)
    Ho, Wo = x.shape[-2:]
    if g.dtype != img.dtype or g.device != img.device or g.shape != (B, Ho, Wo, C):
        raise ValueError(f"g must be {img.dtype} ({B}, {Ho}, {Wo}, {C}) on {img.device}; "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")


def _vec(img, *tensors, channels=None) -> int:
    """Channels per thread: 16 bytes' worth where the channels of a group
    (``channels``, default all of C) and every pointer allow it, else 1."""
    wide = 16 // img.element_size()
    channels = img.shape[-1] if channels is None else channels
    aligned = all(t.data_ptr() % 16 == 0 for t in (img, *tensors))
    return wide if channels % wide == 0 and aligned else 1


def _workspace(img, G: int, Ho: int, Wo: int, shared: bool) -> torch.Tensor:
    """K6's workspace on ``img``'s device: the units' cells, the bin lists
    and their weights, the bins' offsets (csrc/bilinear_gather_backward.cu)."""
    B, H, W, C = img.shape
    nbytes = workspace_kernel()(B, H, W, C, G, Ho, Wo, int(shared))
    if nbytes < 0:
        raise ValueError(f"K6 takes no workspace for img {tuple(img.shape)}, G={G}, "
                         f"Ho={Ho}, Wo={Wo}: more than 2**30 bins or units")
    return torch.empty(nbytes, dtype=torch.uint8, device=img.device)


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
    fp32 coordinates, sums each d_img element in fp32 in an order fixed by
    the inputs and writes it once in ``img``'s dtype (the same bits on every
    call), and returns d_x, d_y in fp32."""
    if img.device.type == "cpu":
        return bilinear_gather_backward_plain(img, x, y, g, padding_mode)
    _check(img, x, y, padding_mode)
    _check_grad(img, x, g)
    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:3]
    d_img, d_x, d_y = torch.empty_like(img), torch.empty_like(x), torch.empty_like(y)
    ws = _workspace(img, 1, Ho, Wo, False)
    _launch(backward_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
            ws.data_ptr(), d_img.data_ptr(), d_x.data_ptr(), d_y.data_ptr(),
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


def bilinear_gather_grouped_forward(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """The grouped gather without its gradient: (B, Ho, Wo, C) in ``img``'s
    dtype. A CPU ``img`` takes the plain version; a CUDA ``img`` launches
    K4, which takes fp32, bf16 and fp16 images with fp32 coordinates
    (B, G, Ho, Wo). Its launches count on ``bilinear_gather_grouped.launches``."""
    if img.device.type == "cpu":
        return bilinear_gather_grouped_plain(img, x, y, padding_mode)
    _check(img, x, y, padding_mode, grouped=True)
    B, H, W, C = img.shape
    G, Ho, Wo = x.shape[1:]
    out = torch.empty((B, Ho, Wo, C), dtype=img.dtype, device=img.device)
    _launch(grouped_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            B, H, W, C, G, Ho, Wo, _DTYPE_CODES[img.dtype], int(padding_mode == "zeros"),
            _vec(img, channels=C // G))
    bilinear_gather_grouped.launches += 1
    return out


def bilinear_gather_grouped_backward(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_img, d_x, d_y) of the grouped gather for the upstream gradient
    ``g`` (B, Ho, Wo, C) in ``img``'s dtype. A CPU ``img`` takes the plain
    version; a CUDA ``img`` launches K6's grouped entry, which takes fp32,
    bf16 and fp16 images with fp32 coordinates, sums d_img as
    ``bilinear_gather_backward`` does (the same bits on every call), and
    returns d_x, d_y (B, G, Ho, Wo) in fp32. Its launches count on
    ``bilinear_gather_grouped_backward.launches``."""
    if img.device.type == "cpu":
        return bilinear_gather_grouped_backward_plain(img, x, y, g, padding_mode)
    _check(img, x, y, padding_mode, grouped=True)
    _check_grad(img, x, g)
    B, H, W, C = img.shape
    G, Ho, Wo = x.shape[1:]
    d_img, d_x, d_y = torch.empty_like(img), torch.empty_like(x), torch.empty_like(y)
    ws = _workspace(img, G, Ho, Wo, False)
    _launch(grouped_backward_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(),
            g.data_ptr(), ws.data_ptr(), d_img.data_ptr(), d_x.data_ptr(), d_y.data_ptr(),
            B, H, W, C, G, Ho, Wo, _DTYPE_CODES[img.dtype], int(padding_mode == "zeros"),
            _vec(img, g, channels=C // G))
    bilinear_gather_grouped_backward.launches += 1
    return d_img, d_x, d_y


class BilinearGatherGrouped(torch.autograd.Function):
    """The grouped gather with its gradient: K4 forward and K6's grouped
    backward on a CUDA tensor, the plain versions of both on a CPU tensor.
    Never runs a plain version on a CUDA tensor."""

    @staticmethod
    def forward(ctx, img, x, y, padding_mode):
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(img, x, y)
        return bilinear_gather_grouped_forward(img, x, y, padding_mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, x, y = ctx.saved_tensors
        d_img, d_x, d_y = bilinear_gather_grouped_backward(img, x, y, g.contiguous(),
                                                           ctx.padding_mode)
        need = ctx.needs_input_grad
        return (d_img if need[0] else None, d_x if need[1] else None,
                d_y if need[2] else None, None)


def bilinear_gather_grouped(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Per-group bilinear sample: channel block g of ``img`` (B, H, W, C) at
    its own pixel coordinates ``x[:, g]``, ``y[:, g]`` ((B, G, Ho, Wo));
    returns (B, Ho, Wo, C) in ``img``'s dtype, with its gradient to all three
    inputs.

    A CPU ``img`` takes the plain versions; a CUDA ``img`` launches K4 (and
    K6's grouped entry in the backward), which take fp32, bf16 and fp16
    images and fp32 coordinates.
    """
    return BilinearGatherGrouped.apply(img, x, y, padding_mode)


def bilinear_gather_multiview_forward(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """The multiview gather without its gradient: (B, Ho, Wo, G*C) in
    ``img``'s dtype. A CPU ``img`` takes the plain version; a CUDA ``img``
    launches K7, which takes fp32, bf16 and fp16 images with fp32 coordinates
    (B, G, Ho, Wo). Its launches count on ``bilinear_gather_multiview.launches``."""
    if img.device.type == "cpu":
        return bilinear_gather_multiview_plain(img, x, y, padding_mode)
    _check(img, x, y, padding_mode, views=True)
    B, H, W, C = img.shape
    G, Ho, Wo = x.shape[1:]
    out = torch.empty((B, Ho, Wo, G * C), dtype=img.dtype, device=img.device)
    _launch(multiview_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            B, H, W, C, G, Ho, Wo, _DTYPE_CODES[img.dtype], int(padding_mode == "zeros"),
            _vec(img), multiview_chunk(B, G, Ho, Wo, sm_count(img.device.index)))
    bilinear_gather_multiview.launches += 1
    return out


def bilinear_gather_multiview_backward(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_img, d_x, d_y) of the multiview gather for the upstream gradient
    ``g`` (B, Ho, Wo, G*C) in ``img``'s dtype. A CPU ``img`` takes the plain
    version; a CUDA ``img`` launches K6's shared-source entry, which takes
    fp32, bf16 and fp16 images with fp32 coordinates, sums d_img over the
    views as ``bilinear_gather_backward`` sums it (the same bits on every
    call), and returns d_x, d_y (B, G, Ho, Wo) in fp32. Its launches count on
    ``bilinear_gather_multiview_backward.launches``."""
    if img.device.type == "cpu":
        return bilinear_gather_multiview_backward_plain(img, x, y, g, padding_mode)
    _check(img, x, y, padding_mode, views=True)
    _check_grad(img, x, g, views=True)
    B, H, W, C = img.shape
    G, Ho, Wo = x.shape[1:]
    d_img, d_x, d_y = torch.empty_like(img), torch.empty_like(x), torch.empty_like(y)
    ws = _workspace(img, G, Ho, Wo, True)
    _launch(multiview_backward_kernel(), img, img.data_ptr(), x.data_ptr(), y.data_ptr(),
            g.data_ptr(), ws.data_ptr(), d_img.data_ptr(), d_x.data_ptr(), d_y.data_ptr(),
            B, H, W, C, G, Ho, Wo, _DTYPE_CODES[img.dtype], int(padding_mode == "zeros"),
            _vec(img, g))
    bilinear_gather_multiview_backward.launches += 1
    return d_img, d_x, d_y


class BilinearGatherMultiview(torch.autograd.Function):
    """The multiview gather with its gradient: K7 forward and K6's
    shared-source backward on a CUDA tensor, the plain versions of both on a
    CPU tensor. Never runs a plain version on a CUDA tensor."""

    @staticmethod
    def forward(ctx, img, x, y, padding_mode):
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(img, x, y)
        return bilinear_gather_multiview_forward(img, x, y, padding_mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, x, y = ctx.saved_tensors
        d_img, d_x, d_y = bilinear_gather_multiview_backward(img, x, y, g.contiguous(),
                                                             ctx.padding_mode)
        need = ctx.needs_input_grad
        return (d_img if need[0] else None, d_x if need[1] else None,
                d_y if need[2] else None, None)


def bilinear_gather_multiview(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """One source sampled at G coordinate sets: all of ``img`` (B, H, W, C)
    at ``x[:, g]``, ``y[:, g]`` ((B, G, Ho, Wo), pixel coordinates); returns
    (B, Ho, Wo, G*C) in ``img``'s dtype, view g in channel block g, with its
    gradient to all three inputs.

    A CPU ``img`` takes the plain versions; a CUDA ``img`` launches K7 (and
    K6's shared-source entry in the backward), which take fp32, bf16 and
    fp16 images and fp32 coordinates.
    """
    return BilinearGatherMultiview.apply(img, x, y, padding_mode)


bilinear_gather.launches = 0
bilinear_gather_backward.launches = 0
bilinear_gather_grouped.launches = 0
bilinear_gather_grouped_backward.launches = 0
bilinear_gather_multiview.launches = 0
bilinear_gather_multiview_backward.launches = 0
