"""EfficientViM HSM-SSD mixer and block (port of ``kmunet_tpu/nn/ssd.py``).

    BCdt = DWConv3x3(1x1Conv(x))            # (3N, L) per batch
    h    = x (softmax_L(dt + A) * B)^T      # (N, C) token -> state compress
    h    = OutProj(h * silu(z) + h * D)     # gated MLP on N states
    y    = h^T C                            # (C, L) state -> token scatter

``HSMSSD(mixer=...)`` picks how the math after the ``bcdt`` conv runs:
``"einsum"`` (the default) as written here; ``"compress"`` the softmax and
the compress through ``kernels.ssd.hsmssd_compress`` (K2 on the card);
``"fused"`` all of it through ``kernels.ssd.hsmssd_mix`` (K3 on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.kernels.ssd import hsmssd_compress, hsmssd_mix
from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.nn.layers import ChannelLayerNorm, ConvBNAct, FFN


MIXERS = ("einsum", "compress", "fused")


class HSMSSD(nn.Module):
    """Hidden-state-mixer SSD over an NCHW tensor whose H*W is a square;
    ``mixer`` one of ``MIXERS`` (the module docstring)."""

    def __init__(self, d_model: int, ssd_expand: int = 1, state_dim: int = 64,
                 a_init_range=(1.0, 16.0), mixer: str = "einsum"):
        super().__init__()
        N = state_dim
        d_inner = int(ssd_expand * d_model)
        if mixer not in MIXERS:
            raise ValueError(f"mixer must be one of {MIXERS}, got {mixer!r}")
        if mixer == "fused" and d_inner != d_model:
            raise ValueError("mixer='fused' takes ssd_expand=1")
        self.path = mixer
        self.a_init_range = a_init_range
        self.BCdt_proj = nn.Parameter(torch.empty(3 * N, d_model))
        self.dw_weight = nn.Parameter(torch.empty(3 * N, 1, 3, 3))
        self.A = nn.Parameter(torch.empty(N))
        self.hz_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.D = nn.Parameter(torch.ones(1))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.BCdt_proj, generator)
        kaiming_uniform_(self.dw_weight, generator)
        self.A.uniform_(*self.a_init_range, generator=generator)

    def forward(self, x: torch.Tensor):
        """x (B, C, H, W) -> (y (B, C, s, s), h (B, N, C)), s*s = H*W: the
        tokens are laid out on the square grid, as in the JAX package."""
        B, C, H, W = x.shape
        L = H * W
        side = math.isqrt(L)
        if side * side != L:
            raise ValueError(f"HSMSSD assumes a square token grid, got L={L}")
        N = self.A.shape[0]
        # The 1x1 projection and the depthwise 3x3 are linear and bias-free:
        # they compose into one 3x3 conv with the rank-1 kernel
        # k[n, c, i, j] = proj[n, c] * dw[n, i, j].
        comp = self.BCdt_proj[:, :, None, None] * self.dw_weight
        grid = x.reshape(B, C, side, side)
        bcdt = F.conv2d(grid, comp.to(x.dtype), padding=1).reshape(B, 3 * N, L)
        Bm, Cm, dt = bcdt.split(N, dim=1)  # each (B, N, L)
        tokens = x.reshape(B, C, L)
        if self.path == "fused":
            y, h_ = hsmssd_mix(tokens, dt, Bm, Cm, self.A, self.hz_proj.weight,
                               self.out_proj.weight, self.D)
            return y.reshape(B, -1, side, side), h_
        if self.path == "compress":
            h = hsmssd_compress(tokens, dt, Bm, self.A)
        else:
            # softmax_L(dt + A) enters only the compress, which is linear in
            # it: normalise after the small (B, N, C) contraction.
            s = dt + self.A[None, :, None]
            e = torch.exp(s - s.amax(dim=2, keepdim=True))
            denom = e.sum(dim=2)  # (B, N)
            h = torch.einsum("bcl,bnl->bnc", tokens, e * Bm) / denom[..., None]
        h_, z = self.hz_proj(h).chunk(2, dim=-1)
        h_ = self.out_proj(h_ * F.silu(z) + h_ * self.D)
        y = torch.einsum("bnc,bnl->bcl", h_, Cm)
        return y.reshape(B, -1, side, side), h_


class EfficientViMBlock(nn.Module):
    """DWConv -> HSM-SSD -> DWConv -> FFN, each blended as (1-a)*x + a*f(x)
    with per-channel a = sigmoid(alpha); ``mixer`` as in ``HSMSSD``."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, ssd_expand: int = 1,
                 state_dim: int = 64, mixer: str = "einsum"):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((4, dim), 1e-4))
        self.dwconv1 = ConvBNAct(dim, dim, (3, 3), groups=dim, bn_weight_init=0.0, act=None)
        self.norm = ChannelLayerNorm(dim)
        self.mixer = HSMSSD(dim, ssd_expand, state_dim, mixer=mixer)
        self.dwconv2 = ConvBNAct(dim, dim, (3, 3), groups=dim, bn_weight_init=0.0, act=None)
        self.ffn = FFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.alpha)[:, None, :, None, None]  # (4, 1, C, 1, 1)
        x = (1 - a[0]) * x + a[0] * self.dwconv1(x)
        y, _ = self.mixer(self.norm(x))
        x = (1 - a[1]) * x + a[1] * y
        x = (1 - a[2]) * x + a[2] * self.dwconv2(x)
        return (1 - a[3]) * x + a[3] * self.ffn(x)
