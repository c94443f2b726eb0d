"""K1, the fused KAN convolution, in the port's NCHW layout:

    out = conv(silu(xp), base_weight) + conv(B(xp), spline_flat)

over a zero-padded input ``xp`` (B, C, H+2, W+2), stride 1, 3x3, with ``B``
the cubic B-spline basis (8 functions per channel, grid 5 on [-1, 1]) and
``spline_flat`` (F, C*8, 3, 3) c-major (channel ``c*8 + q`` is basis ``q`` of
input channel ``c``), as ``KANConv2d`` makes it from ``spline_weight *
spline_scaler``. The port's counterpart of ``kmunet_tpu/kernels/
kanconv_pallas.py::fused_kanconv``; the CUDA kernel is in ``csrc/kanconv.cu``,
whose source note says what bounds it and how it is laid out.

``fused_kanconv`` is what callers use: on a CPU tensor it runs the plain
version (autograd differentiates it); on a CUDA tensor it applies
``FusedKANConv``, an autograd function whose forward launches K1 and whose
backward recomputes through the plain version and returns its autograd
gradients, as the JAX package's custom VJP returns those of
``kanconv_reference``. Nothing falls back: the launcher ``kanconv_forward``
raises on anything it does not take, a CPU tensor included, and counts its
launches on ``fused_kanconv.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from kmunet_tpu_torch.kernels import build
from kmunet_tpu_torch.kernels.ssd import plain_gradients
from kmunet_tpu_torch.ops.spline import cardinal_bspline_basis_flat

SOURCE = "kanconv.cu"
N_BASIS = 8  # grid 5, cubic: the bases K1 evaluates
F_TILE = 16  # output channels per block (csrc's kFT): the weights are padded to it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kanconv_plain(xp, base_weight, spline_flat, grid_size: int = 5,
                  spline_order: int = 3) -> torch.Tensor:
    """Plain PyTorch version of K1, the port of ``kanconv_reference``
    (``kanconv_pallas.py:108``) in NCHW/OIHW: xp (B, C, Hp, Wp), base_weight
    (F, C, k, k), spline_flat (F, C*n, k, k) -> (B, F, Hp-k+1, Wp-k+1) in the
    input's dtype, with ``n = grid_size + spline_order`` bases per channel
    (K1's are grid 5, cubic)."""
    basis = cardinal_bspline_basis_flat(xp, grid_size, spline_order)
    return F.conv2d(F.silu(xp), base_weight) + F.conv2d(basis, spline_flat)


@functools.cache
def kernel() -> ctypes._CFuncPtr:
    """K1's entry point, built from ``csrc/kanconv.cu`` on first use."""
    fn = ctypes.CDLL(str(build.build(SOURCE).path)).kmunet_kanconv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xp, base_weight, spline_flat) -> None:
    if xp.dtype not in _DTYPE_CODES:
        raise TypeError(f"xp dtype {xp.dtype} not in {list(_DTYPE_CODES)}")
    if xp.dim() != 4 or not xp.is_contiguous():
        raise ValueError(f"want a contiguous xp (B, C, Hp, Wp); got {tuple(xp.shape)}")
    Bsz, C, Hp, Wp = xp.shape
    Fo = base_weight.shape[0]
    if tuple(base_weight.shape) != (Fo, C, 3, 3):
        raise ValueError(f"K1 takes a 3x3 base_weight (F, {C}, 3, 3); got "
                         f"{tuple(base_weight.shape)}")
    if tuple(spline_flat.shape) != (Fo, C * N_BASIS, 3, 3):
        raise ValueError(f"want spline_flat ({Fo}, {C * N_BASIS}, 3, 3); got "
                         f"{tuple(spline_flat.shape)}")
    for name, t in (("base_weight", base_weight), ("spline_flat", spline_flat)):
        if t.device != xp.device or not t.is_floating_point():
            raise TypeError(f"{name} must be floating on {xp.device}, got {t.dtype} on {t.device}")
    if Hp < 3 or Wp < 3 or not 1 <= Bsz <= 65535:
        raise ValueError(f"K1 takes Hp, Wp >= 3 and 1 <= B <= 65535; got {tuple(xp.shape)}")
    if not xp.is_cuda:
        raise ValueError(f"the CUDA KAN conv needs a CUDA tensor, got {xp.device}")


def _weights(base_weight, spline_flat):
    """The weights as K1 reads them, fp32 (C, 9 taps, 9 terms, Fp): term 0
    the base weight, terms 1-8 the spline weights of the 8 bases; F padded
    with zeros to Fp, a multiple of F_TILE."""
    Fo, C = base_weight.shape[:2]
    terms = torch.cat([base_weight.float().reshape(Fo, C, 1, 9),
                       spline_flat.float().reshape(Fo, C, N_BASIS, 9)], dim=2)
    return F.pad(terms.permute(1, 3, 2, 0), (0, -Fo % F_TILE)).contiguous()


def kanconv_forward(xp, base_weight, spline_flat) -> torch.Tensor:
    """K1 on CUDA tensors: (B, F, Hp-2, Wp-2) in xp's dtype (fp32, bf16 or
    fp16); the weights of any float dtype, reordered to fp32 here once per
    call (a few KB). Raises on what the kernel does not take. Counts its
    launches on ``fused_kanconv.launches``."""
    _check(xp, base_weight, spline_flat)
    Bsz, C, Hp, Wp = xp.shape
    Fo = base_weight.shape[0]
    wk = _weights(base_weight, spline_flat)
    out = torch.empty(Bsz, Fo, Hp - 2, Wp - 2, dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = kernel()(xp.data_ptr(), wk.data_ptr(), out.data_ptr(), Bsz, C, Fo, Hp - 2, Wp - 2,
                       _DTYPE_CODES[xp.dtype], stream)
    if err != 0:
        raise RuntimeError(f"kmunet_kanconv launch failed: error {err}")
    fused_kanconv.launches += 1
    return out


class FusedKANConv(torch.autograd.Function):
    """K1 forward, the plain version's gradient backward
    (``kanconv_pallas.py:181``)."""

    @staticmethod
    def forward(ctx, xp, base_weight, spline_flat):
        ctx.save_for_backward(xp, base_weight, spline_flat)
        return kanconv_forward(xp, base_weight, spline_flat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return plain_gradients(kanconv_plain, ctx.saved_tensors, ctx.needs_input_grad, (g,))


def fused_kanconv(xp, base_weight, spline_flat) -> torch.Tensor:
    """The KAN conv over the padded ``xp`` with its gradient: the plain
    version on a CPU ``xp``, K1 on a CUDA ``xp``."""
    if xp.device.type == "cpu":
        return kanconv_plain(xp, base_weight, spline_flat)
    return FusedKANConv.apply(xp.contiguous(), base_weight, spline_flat)


fused_kanconv.launches = 0
