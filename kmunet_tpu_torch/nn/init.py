"""Seeded initialisers with the JAX package's distributions (``kmunet_tpu/nn/init.py``).

Weights are in PyTorch layout: a conv weight is (out, in/groups, kh, kw), a
linear weight (out, in). Fans are counted as the JAX package counts them for
the same tensor in its layout. Every initialiser takes an explicit
``torch.Generator`` and writes in place.
"""

from __future__ import annotations

import math

import torch


def fans(shape) -> tuple[int, int]:
    """(fan_in, fan_out) of a weight whose dim 0 is the output and dim 1 the input."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def kaiming_uniform_(t: torch.Tensor, generator: torch.Generator, fan_in: int | None = None,
                     scale: float = 1.0) -> torch.Tensor:
    """PyTorch's default layer init: U(-b, b), b = scale / sqrt(fan_in)."""
    fan_in = fans(t.shape)[0] if fan_in is None else fan_in
    bound = scale / math.sqrt(max(fan_in, 1))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_fanout_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """kaiming_normal_(mode='fan_out'): N(0, 2 / fan_out)."""
    std = math.sqrt(2.0 / max(fans(t.shape)[1], 1))
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, generator: torch.Generator, std: float = 1.0,
            mean: float = 0.0) -> torch.Tensor:
    return t.normal_(mean, std, generator=generator)


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, generator: torch.Generator, std: float) -> torch.Tensor:
    """flax's ``truncated_normal(std)``: N(0, std^2) cut at +-2 std (the
    untruncated std, as JAX's initializer)."""
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``xavier_uniform()``: U(-b, b), b = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = fans(t.shape)
    bound = math.sqrt(6.0 / max(fan_in + fan_out, 1))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_module_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded initialisation of a module tree with the JAX package's
    distributions: every conv and linear PyTorch's default kaiming-uniform
    weight and a zero bias, then every module with its own rule
    (``init_weights_``) applies it. Norms, BN statistics and the constant
    parameters keep the values their constructors give."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            kaiming_uniform_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_weights_"):
            m.init_weights_(generator)
    return model
