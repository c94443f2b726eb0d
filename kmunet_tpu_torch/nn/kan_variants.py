"""Alternative KAN basis layers (port of ``kmunet_tpu/nn/kan_variants.py``):
Chebyshev (clamp, acos, cos), FastKAN (Gaussian RBF), FasterKAN (RSWAF
sech^2 with the reference's hand-written, approximate backward), GRAM (Gram
polynomials), WavKAN (five mother wavelets), Jacobi (three-term
recurrence), ReLUKAN (squared ReLU windows) and RBFKAN. Only ``KANLinear``
and ``KANConv2d`` (``nn/kan.py``) are wired into KM_UNetV3; these exist for
the library's breadth.

Every layer acts on the trailing feature axis of an input of any rank and
takes its input width at construction. Parameters without a PyTorch
counterpart keep the flax name and layout (``cheby_coeffs`` (in, out,
degree + 1), ...); dense layers are ``nn.Linear``s under the flax names.
``PatchKANConv2d`` runs any of them over the k x k patches of an NCHW
tensor, unfolded in torch's (C, kh, kw) order, as the JAX module extracts
them.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import normal_, truncated_normal_
from kmunet_tpu_torch.nn.layers import batch_norm_train


@torch.no_grad()
def _xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``xavier_uniform()`` on a leaf in flax layout: in axis -2, out
    axis -1, the other axes the receptive field."""
    receptive = math.prod(t.shape[:-2]) if t.dim() > 2 else 1
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=generator)


def _grid(lo: float, hi: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace(lo, hi, n)`` in fp32, as the JAX layers build it."""
    return torch.from_numpy(np.linspace(lo, hi, n).astype(np.float32)).to(like.device, like.dtype)


class ChebyKANLayer(nn.Module):
    """y = sum_d cos(d acos(clamp(x, -1, 1))) . cheby_coeffs."""

    def __init__(self, in_features: int, features: int, degree: int = 4):
        super().__init__()
        self.degree = degree
        self.cheby_coeffs = nn.Parameter(torch.empty(in_features, features, degree + 1))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        in_dim = self.cheby_coeffs.shape[0]
        normal_(self.cheby_coeffs, generator, std=1.0 / (in_dim * (self.degree + 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = torch.arange(self.degree + 1, dtype=x.dtype, device=x.device)
        basis = torch.cos(torch.acos(x.clamp(-1.0, 1.0))[..., None] * d)
        return torch.einsum("...id,iod->...o", basis, self.cheby_coeffs)


class FastKANLayer(nn.Module):
    """LayerNorm, a Gaussian-RBF grid, a bias-free linear; plus a linear on
    silu(x) (``use_base``)."""

    def __init__(self, in_features: int, features: int, grid_min: float = -2.0,
                 grid_max: float = 2.0, num_grids: int = 8, use_base: bool = True):
        super().__init__()
        self.grid = (grid_min, grid_max, num_grids)
        self.layernorm = nn.LayerNorm(in_features, eps=1e-5)
        self.spline_linear = nn.Linear(in_features * num_grids, features, bias=False)
        self.base_linear = nn.Linear(in_features, features) if use_base else None

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        truncated_normal_(self.spline_linear.weight, generator, 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi, n = self.grid
        xn = self.layernorm(x)
        basis = torch.exp(-(((xn[..., None] - _grid(lo, hi, n, x)) / ((hi - lo) / (n - 1))) ** 2))
        ret = self.spline_linear(basis.flatten(-2))
        if self.base_linear is not None:
            ret = ret + self.base_linear(F.silu(x))
        return ret


class _RSWAF(torch.autograd.Function):
    """sech^2(x - grid) with the reference's backward: the input gradient
    sum_g -2 tanh sech^2 g times ``inv_denominator``, which the forward does
    not apply (both quirks kept, as the JAX layer's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, grid, inv_denominator):
        t = torch.tanh(x[..., None] - grid)
        sech2 = 1.0 - t * t
        ctx.save_for_backward(t, sech2)
        ctx.inv_denominator = inv_denominator
        return sech2

    @staticmethod
    def backward(ctx, g):
        t, sech2 = ctx.saved_tensors
        return (-2.0 * t * sech2 * g).sum(-1) * ctx.inv_denominator, None, None


class FasterKANLayer(nn.Module):
    """LayerNorm, the RSWAF basis (``_RSWAF``), a bias-free xavier linear."""

    def __init__(self, in_features: int, features: int, grid_min: float = -1.2,
                 grid_max: float = 0.2, num_grids: int = 8, inv_denominator: float = 0.5):
        super().__init__()
        self.grid = (grid_min, grid_max, num_grids)
        self.inv_denominator = inv_denominator
        self.layernorm = nn.LayerNorm(in_features, eps=1e-5)
        self.spline_linear = nn.Linear(in_features * num_grids, features, bias=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        _xavier_uniform_(self.spline_linear.weight.T, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        basis = _RSWAF.apply(self.layernorm(x), _grid(*self.grid, x), self.inv_denominator)
        return self.spline_linear(basis.flatten(-2))


class GRAMLayer(nn.Module):
    """silu(x) . base_weights plus the Gram polynomials of tanh(x) (their
    recurrence weighted by ``beta_weights``) through silu and
    ``grams_basis_weights``; LayerNorm, then silu."""

    def __init__(self, in_features: int, features: int, degree: int = 3,
                 act: Callable = F.silu):
        super().__init__()
        self.degree, self.act = degree, act
        self.beta_weights = nn.Parameter(torch.empty(degree + 1))
        self.grams_basis_weights = nn.Parameter(torch.empty(in_features, features, degree + 1))
        self.base_weights = nn.Parameter(torch.empty(in_features, features))
        self.norm = nn.LayerNorm(features, eps=1e-5)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        in_dim = self.base_weights.shape[0]
        normal_(self.beta_weights, generator, std=1.0 / (in_dim * (self.degree + 1.0)))
        _xavier_uniform_(self.grams_basis_weights, generator)
        _xavier_uniform_(self.base_weights, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        basis = self.act(x) @ self.base_weights
        xt = torch.tanh(x)
        polys = [torch.ones_like(xt)]
        if self.degree >= 1:
            polys.append(xt)
        for i in range(2, self.degree + 1):
            n, m = i - 1, i
            beta = (((m + n) * (m - n) * n ** 2) / (m ** 2 / (4.0 * n ** 2 - 1.0))) * \
                self.beta_weights[n]
            polys.append(xt * polys[-1] - beta * polys[-2])
        grams = self.act(torch.stack(polys, dim=-1))
        y = torch.einsum("...ld,lod->...o", grams, self.grams_basis_weights)
        return self.act(self.norm(y + basis))


class WavKANLayer(nn.Module):
    """A mother wavelet of (x - translation) / scale per (out, in), summed
    with ``wavelet_weights``, plus silu(x) . weight1^T; BatchNorm over the
    features (flax's, in training: ``batch_norm_train``)."""

    WAVELETS = ("mexican_hat", "morlet", "dog", "meyer", "shannon")

    def __init__(self, in_features: int, features: int, wavelet_type: str = "mexican_hat"):
        super().__init__()
        if wavelet_type not in self.WAVELETS:
            raise ValueError(f"unsupported wavelet {wavelet_type}")
        self.wavelet_type = wavelet_type
        self.scale = nn.Parameter(torch.ones(features, in_features))
        self.translation = nn.Parameter(torch.zeros(features, in_features))
        self.wavelet_weights = nn.Parameter(torch.empty(features, in_features))
        self.weight1 = nn.Parameter(torch.empty(features, in_features))
        self.bn = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        # kaiming_uniform_torch on the flax (features, in) leaf: fan_in = features.
        bound = 1.0 / math.sqrt(self.scale.shape[0])
        for p in (self.wavelet_weights, self.weight1):
            p.uniform_(-bound, bound, generator=generator)

    def _wavelet(self, xs: torch.Tensor) -> torch.Tensor:
        kind = self.wavelet_type
        if kind == "mexican_hat":
            c = 2.0 / (math.sqrt(3) * math.pi ** 0.25)
            return c * (xs ** 2 - 1) * torch.exp(-0.5 * xs ** 2)
        if kind == "morlet":
            return torch.exp(-0.5 * xs ** 2) * torch.cos(5.0 * xs)
        if kind == "dog":
            return -xs * torch.exp(-0.5 * xs ** 2)
        if kind == "meyer":
            v = xs.abs()
            t = 2 * v - 1
            nu = t ** 4 * (35 - 84 * t + 70 * t ** 2 - 20 * t ** 3)
            aux = torch.where(v <= 0.5, 1.0,
                              torch.where(v >= 1.0, 0.0, torch.cos(math.pi / 2 * nu)))
            return torch.sin(math.pi * v) * aux
        n = xs.shape[-1]
        window = 0.54 - 0.46 * torch.cos(2 * math.pi * torch.arange(n, device=xs.device,
                                                                     dtype=xs.dtype) / (n - 1))
        return torch.sinc(xs / math.pi) * window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = (x[..., None, :] - self.translation) / self.scale  # (..., out, in)
        y = (self._wavelet(xs) * self.wavelet_weights).sum(-1) + F.silu(x) @ self.weight1.T
        if self.training:
            return batch_norm_train(y, self.bn, channel_dim=-1)
        bn = self.bn
        return (y - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps) * bn.weight + bn.bias


class JacobiKANLayer(nn.Module):
    """silu(x) . base_weights plus the Jacobi polynomials P^(a, b) of
    tanh(x) by their three-term recurrence . jacobi_coeffs; LayerNorm, then
    silu."""

    def __init__(self, in_features: int, features: int, degree: int = 4, a: float = 1.0,
                 b: float = 1.0, act: Callable = F.silu):
        super().__init__()
        self.degree, self.a, self.b, self.act = degree, a, b, act
        self.base_weights = nn.Parameter(torch.empty(in_features, features))
        self.jacobi_coeffs = nn.Parameter(torch.empty(in_features, features, degree + 1))
        self.norm = nn.LayerNorm(features, eps=1e-5)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        in_dim = self.base_weights.shape[0]
        _xavier_uniform_(self.base_weights, generator)
        normal_(self.jacobi_coeffs, generator, std=1.0 / (in_dim * (self.degree + 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        basis = self.act(x) @ self.base_weights
        xt = torch.tanh(x)
        a, b = self.a, self.b
        polys = [torch.ones_like(xt)]
        if self.degree >= 1:
            polys.append(((a - b) + (a + b + 2) * xt) / 2.0)
        for i in range(2, self.degree + 1):
            t_k = (2 * i + a + b) * (2 * i + a + b - 1) / (2 * i * (i + a + b))
            t_k1 = ((2 * i + a + b - 1) * (a * a - b * b)
                    / (2 * i * (i + a + b) * (2 * i + a + b - 2)))
            t_k2 = ((i + a - 1) * (i + b - 1) * (2 * i + a + b)
                    / (i * (i + a + b) * (2 * i + a + b - 2)))
            polys.append((t_k * xt + t_k1) * polys[-1] - t_k2 * polys[-2])
        y = torch.einsum("...id,iod->...o", torch.stack(polys, dim=-1), self.jacobi_coeffs)
        return self.act(self.norm(y + basis))


class ReLUKANLayer(nn.Module):
    """(relu(x - low) relu(high - x) r)^2 over g + k windows per input, then
    a linear over all of them (the reference's "equal size conv")."""

    def __init__(self, in_features: int, features: int, g: int = 5, k: int = 3,
                 train_ab: bool = True):
        super().__init__()
        self.r = 4.0 * g * g / ((k + 1) * (k + 1))
        low = np.arange(-k, g) / g
        low, high = (torch.from_numpy(np.tile(v, (in_features, 1)).astype(np.float32))
                     for v in (low, low + (k + 1) / g))
        if train_ab:
            self.phase_low, self.phase_height = nn.Parameter(low), nn.Parameter(high)
        else:
            self.register_buffer("phase_low", low, persistent=False)
            self.register_buffer("phase_height", high, persistent=False)
        self.equal_size_conv = nn.Linear(in_features * (g + k), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.relu(x[..., None] - self.phase_low)
        x2 = F.relu(self.phase_height - x[..., None])
        return self.equal_size_conv(((x1 * x2 * self.r) ** 2).flatten(-2))


class RBFKANLayer(nn.Module):
    """A Gaussian-RBF grid through a bias-free linear, plus a linear on
    silu(x) (``use_base``); no LayerNorm."""

    def __init__(self, in_features: int, features: int, grid_min: float = -2.0,
                 grid_max: float = 2.0, num_grids: int = 8, use_base: bool = True):
        super().__init__()
        self.grid = (grid_min, grid_max, num_grids)
        self.rbf_linear = nn.Linear(in_features * num_grids, features, bias=False)
        self.base_linear = nn.Linear(in_features, features) if use_base else None

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        normal_(self.rbf_linear.weight, generator, std=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi, n = self.grid
        basis = torch.exp(-(((x[..., None] - _grid(lo, hi, n, x)) / ((hi - lo) / (n - 1))) ** 2))
        ret = self.rbf_linear(basis.flatten(-2))
        if self.base_linear is not None:
            ret = ret + self.base_linear(F.silu(x))
        return ret


class PatchKANConv2d(nn.Module):
    """Any trailing-axis KAN layer over the zero-padded k x k patches of x
    (B, C, H, W), each patch's features in torch-unfold (C, kh, kw) order
    (the layer's input width is C k^2) -> (B, out, Ho, Wo)."""

    def __init__(self, layer: nn.Module, kernel_size: int = 3, stride: int = 1, padding: int = 0):
        super().__init__()
        self.layer = layer
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        k, s, p = self.kernel_size, self.stride, self.padding
        Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        patches = F.unfold(x, k, padding=p, stride=s)  # (B, C k k, Ho Wo)
        y = self.layer(patches.transpose(1, 2).reshape(B, Ho, Wo, -1))
        return y.permute(0, 3, 1, 2)
