"""Mamba (S6) block (port of ``kmunet_tpu/nn/mamba.py``), on (B, L, D) tokens.

    in_proj -> (x, z);  x -> causal depthwise conv1d(d_conv) -> silu
    x_proj(x) -> (dt_raw, B, C);  dt = softplus(dt_raw @ dt_proj + bias)
    A = -exp(A_log);  y = selective_scan(x, dt, A, B, C, D) * silu(z) -> out_proj

The scan is K8 on a CUDA tensor (``ops/scan.py``); with ``seq_mesh`` (a
``parallel.Mesh``) it is ``selective_scan_sharded``, L cut over the mesh's
``seq_axis``, each rank's chunk through K8. ``A`` is computed from
``A_log`` in the parameters' dtype, as the JAX block computes it from the
parameters the engine has cast to the compute dtype; the kernel takes it in
fp32 from there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.ops.scan import selective_scan, selective_scan_sharded


class MambaBlock(nn.Module):
    """``mamba_ssm.Mamba`` semantics: d_inner = expand * d_model, dt_rank =
    ceil(d_model / 16). Parameters under the flax names, in PyTorch layout:
    ``conv1d_weight`` (d_inner, 1, d_conv) is flax's ``conv1d_kernel``
    (d_conv, 1, d_inner), ``dt_proj_weight`` (d_inner, dt_rank) its
    ``dt_proj_kernel`` (dt_rank, d_inner). ``seq_mesh``, ``seq_axis`` and
    ``batch_axis`` are the JAX block's fields (``selective_scan_sharded``)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 seq_mesh=None, seq_axis: str = "spatial", batch_axis: str = "data"):
        super().__init__()
        self.seq_mesh, self.seq_axis, self.batch_axis = seq_mesh, seq_axis, batch_axis
        d_inner = expand * d_model
        self.d_inner, self.d_state, self.d_conv = d_inner, d_state, d_conv
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d_weight = nn.Parameter(torch.empty(d_inner, 1, d_conv))
        self.conv1d_bias = nn.Parameter(torch.zeros(d_inner))
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj_weight = nn.Parameter(torch.empty(d_inner, self.dt_rank))
        self.dt_proj_bias = nn.Parameter(torch.empty(d_inner))
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX block's inits: the conv PyTorch's default kaiming-uniform
        (fan-in d_conv) with a zero bias; dt_proj U(+-dt_rank^-0.5) and its
        bias the inverse softplus of dt ~ LogUniform(1e-3, 0.1), at least
        1e-4; A_log = log(1..d_state) in every row; D = 1. The projections
        are linears of the model-wide rule."""
        kaiming_uniform_(self.conv1d_weight, generator)
        self.conv1d_bias.zero_()
        bound = self.dt_rank ** -0.5
        self.dt_proj_weight.uniform_(-bound, bound, generator=generator)
        u = torch.rand(self.d_inner, generator=generator)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
        self.dt_proj_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                         .repeat(self.d_inner, 1))
        self.D.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, d_model) -> (B, L, d_model)."""
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        # Causal depthwise conv1d over L: d_conv - 1 zeros on the left.
        xc = F.conv1d(F.pad(xs.transpose(1, 2), (self.d_conv - 1, 0)), self.conv1d_weight,
                      self.conv1d_bias, groups=self.d_inner).transpose(1, 2)
        xc = F.silu(xc)
        dt_raw, Bm, Cm = self.x_proj(xc).split([self.dt_rank, self.d_state, self.d_state], -1)
        dt = F.softplus(F.linear(dt_raw, self.dt_proj_weight, self.dt_proj_bias))
        A = -torch.exp(self.A_log)
        if self.seq_mesh is not None:
            y = selective_scan_sharded(xc, dt, A, Bm, Cm, self.D, self.seq_mesh,
                                       axis=self.seq_axis, batch_axis=self.batch_axis)
        else:
            y = selective_scan(xc, dt, A, Bm, Cm, self.D)
        return self.out_proj(y * F.silu(z))
