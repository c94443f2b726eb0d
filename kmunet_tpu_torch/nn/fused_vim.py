"""The EnhancedViM block's three direction branches in one chain, and the
vmapped layout's stacked branches (port of ``kmunet_tpu/nn/fused_vim.py``
and of the ``nn.vmap`` branch of ``kmunet_tpu/models/km_unet.py``'s
``EnhancedViMBlock``).

``FusedDirectionViM`` evaluates the height, width and channel branches
(each a direction projection, an EfficientViM block and a
DirectionAttention) over one channel-stacked (B, 3C, H, W) tensor, channel
``g * C + c`` of branch g: the three projections are one 3x3 conv whose
kernel embeds each branch's taps; per-branch convs become one grouped conv
(``packing="grouped"``) or one dense conv with a block-diagonal kernel
(``"blockdiag"``); per-branch dense layers become batched products over the
branch axis; depthwise convs and BatchNorms concatenate; the per-branch
LayerNorm normalises each branch's C channels. The same function as the
separate branches.

``fuse_direction_params`` and ``unfuse_direction_params`` move a state dict
between the separate layout (``height_block``, ``width_block``,
``channel_block``) and the fused one (``directions``), both ways exactly.

``StackedBranches`` holds three copies of a module as stacked leaves (a
leading axis of 3, as ``nn.vmap`` stores ``vit_mamba3`` and ``attn3``) and
applies copy i to input i.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import fans, init_module_, kaiming_uniform_
from kmunet_tpu_torch.nn.layers import batch_norm

BRANCHES = ("height_block", "width_block", "channel_block")
PACKINGS = ("grouped", "blockdiag")
G = 3


def _blockdiag(w: torch.Tensor) -> torch.Tensor:
    """(G, O, I, kh, kw) per-branch kernels -> (G O, G I, kh, kw), zeros off
    the diagonal blocks."""
    g, o, i, kh, kw = w.shape
    out = w.new_zeros(g * o, g * i, kh, kw)
    for b in range(g):
        out[b * o:(b + 1) * o, b * i:(b + 1) * i] = w[b]
    return out


class FusedDirectionViM(nn.Module):
    """(B, C, H, W) -> the three branches' features (B, 3, C, H, W); the
    inner blocks use 64 states (the reference's quirk, as the separate
    branches). Parameters in PyTorch layouts with a leading branch axis."""

    def __init__(self, channels: int, packing: str = "grouped"):
        super().__init__()
        if packing not in PACKINGS:
            raise ValueError(f"packing must be one of {PACKINGS}, got {packing!r}")
        C, N = channels, 64
        self.packing = packing
        e = lambda *s: nn.Parameter(torch.empty(*s))  # noqa: E731
        self.proj_h_weight, self.proj_w_weight, self.proj_c_weight = (
            e(C, C, 3, 1), e(C, C, 1, 3), e(C, C, 1, 1))
        self.proj_bias = nn.Parameter(torch.zeros(G, C))
        self.alpha = nn.Parameter(torch.full((G, 4, C), 1e-4))
        self.dw1_weight, self.dw2_weight = e(G, C, 1, 3, 3), e(G, C, 1, 3, 3)
        self.ln_scale = nn.Parameter(torch.ones(G, C))
        self.ln_bias = nn.Parameter(torch.zeros(G, C))
        self.BCdt_proj, self.BCdt_dw = e(G, 3 * N, C), e(G, 3 * N, 1, 3, 3)
        self.A = e(G, N)
        self.hz_weight, self.out_weight = e(G, 2 * C, C), e(G, C, C)
        self.D = nn.Parameter(torch.ones(G, 1))
        self.ffn1_weight, self.ffn2_weight = e(G, 4 * C, C, 1, 1), e(G, C, 4 * C, 1, 1)
        self.gate1_weight, self.gate2_weight = e(G, C // 4, C), e(G, C, C // 4)
        self.gate1_bias = nn.Parameter(torch.zeros(G, C // 4))
        self.gate2_bias = nn.Parameter(torch.zeros(G, C))
        self.qkv_weight = e(G, 3 * C, C, 1, 1)
        self.qkv_bias = nn.Parameter(torch.zeros(G, 3 * C))
        self.attn_dw_weight = e(G, C, 1, 3, 3)
        self.attn_dw_bias = nn.Parameter(torch.zeros(G, C))
        for name, width, scale in (("bn1", C, 0.0), ("bn2", C, 0.0), ("ffn_bn1", 4 * C, 1.0),
                                   ("ffn_bn2", C, 0.0)):
            bn = nn.BatchNorm2d(G * width, eps=1e-5, momentum=0.1)
            nn.init.constant_(bn.weight, scale)
            setattr(self, name, bn)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX module's init: each kernel kaiming-uniform, the stacked
        ones over one branch's fan (the leading axis is the stack); A
        U(1, 16); biases 0."""
        for name, p in self.named_parameters(recurse=False):
            if name.startswith("proj_") and name != "proj_bias":
                kaiming_uniform_(p, generator)
            elif name.endswith("_weight") or name.startswith("BCdt_"):
                kaiming_uniform_(p, generator, fan_in=fans(p.shape[1:])[0])
        self.A.uniform_(1.0, 16.0, generator=generator)

    def _conv(self, u, w, groups_dw=False, bias=None):
        """A per-branch conv of u (B, G I, H, W) with w (G, O, I, kh, kw):
        depthwise, grouped or block-diagonal; stride 1, "SAME"."""
        g, o, i, kh, kw = w.shape
        if groups_dw:
            k, groups = w.reshape(g * o, i, kh, kw), u.shape[1]
        elif self.packing == "grouped":
            k, groups = w.reshape(g * o, i, kh, kw), g
        else:
            k, groups = _blockdiag(w), 1
        return F.conv2d(u, k.to(u.dtype), None if bias is None else bias.reshape(-1).to(u.dtype),
                        padding=(kh // 2, kw // 2), groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        N, L = self.A.shape[1], H * W
        cd = lambda t: t.reshape(1, -1, 1, 1).to(x.dtype)  # noqa: E731  fused-channel order
        K = torch.cat([F.pad(self.proj_h_weight, (1, 1, 0, 0)),
                       F.pad(self.proj_w_weight, (0, 0, 1, 1)),
                       F.pad(self.proj_c_weight, (1, 1, 1, 1))])  # (3C, C, 3, 3)
        u = F.conv2d(x, K.to(x.dtype), self.proj_bias.reshape(-1).to(x.dtype), padding=1)

        a = torch.sigmoid(self.alpha)  # (G, 4, C)
        u = (1 - cd(a[:, 0])) * u + cd(a[:, 0]) * batch_norm(
            self._conv(u, self.dw1_weight, groups_dw=True), self.bn1)

        u_prev = u
        t = u.reshape(B, G, C, H, W)
        mu = t.mean(dim=2, keepdim=True)
        var = (t - mu).square().mean(dim=2, keepdim=True)
        t = (t - mu) * torch.rsqrt(var + 1e-5)
        t = t * self.ln_scale[None, :, :, None, None] + self.ln_bias[None, :, :, None, None]

        comp = self.BCdt_proj[..., None, None] * self.BCdt_dw  # (G, 3N, C, 3, 3)
        bcdt = self._conv(t.reshape(B, G * C, H, W), comp).reshape(B, G, 3 * N, L)
        Bm, Cm, dt = bcdt.split(N, dim=2)  # (B, G, N, L)
        s = dt + self.A[None, :, :, None]
        e = torch.exp(s - s.amax(dim=3, keepdim=True))
        h = torch.einsum("bgcl,bgnl->bgnc", t.reshape(B, G, C, L), e * Bm)
        h = h / e.sum(dim=3)[..., None]
        h_, z = torch.einsum("bgnc,gdc->bgnd", h, self.hz_weight).chunk(2, dim=-1)
        gated = h_ * F.silu(z) + h_ * self.D[None, :, :, None]
        h2 = torch.einsum("bgnc,gdc->bgnd", gated, self.out_weight)
        y = torch.einsum("bgnc,bgnl->bgcl", h2, Cm).reshape(B, G * C, H, W)
        u = (1 - cd(a[:, 1])) * u_prev + cd(a[:, 1]) * y

        u = (1 - cd(a[:, 2])) * u + cd(a[:, 2]) * batch_norm(
            self._conv(u, self.dw2_weight, groups_dw=True), self.bn2)
        f = F.relu(batch_norm(self._conv(u, self.ffn1_weight), self.ffn_bn1))
        f = batch_norm(self._conv(f, self.ffn2_weight), self.ffn_bn2)
        u = (1 - cd(a[:, 3])) * u + cd(a[:, 3]) * f

        pooled = u.mean(dim=(2, 3)).reshape(B, G, C)
        w = torch.einsum("bgc,gdc->bgd", pooled, self.gate1_weight) + self.gate1_bias
        w = torch.einsum("bgd,gcd->bgc", F.gelu(w), self.gate2_weight) + self.gate2_bias
        qkv = self._conv(u, self.qkv_weight, bias=self.qkv_bias).reshape(B, G, 3, C, H, W)
        attn = (torch.sigmoid(qkv[:, :, 0] * qkv[:, :, 1]) * qkv[:, :, 2]).reshape(B, G * C, H, W)
        attn = self._conv(attn, self.attn_dw_weight, groups_dw=True, bias=self.attn_dw_bias)
        return (attn * torch.sigmoid(w).reshape(B, G * C, 1, 1)).reshape(B, G, C, H, W)


# (fused leaf, the branch's key under its block) stacked on a leading axis.
_STACKED = (
    ("proj_bias", "proj.bias"),
    ("alpha", "vit_mamba.alpha"),
    ("dw1_weight", "vit_mamba.dwconv1.Conv_0.weight"),
    ("ln_scale", "vit_mamba.norm.weight"),
    ("ln_bias", "vit_mamba.norm.bias"),
    ("BCdt_proj", "vit_mamba.mixer.BCdt_proj"),
    ("BCdt_dw", "vit_mamba.mixer.dw_weight"),
    ("A", "vit_mamba.mixer.A"),
    ("hz_weight", "vit_mamba.mixer.hz_proj.weight"),
    ("D", "vit_mamba.mixer.D"),
    ("out_weight", "vit_mamba.mixer.out_proj.weight"),
    ("dw2_weight", "vit_mamba.dwconv2.Conv_0.weight"),
    ("ffn1_weight", "vit_mamba.ffn.ConvBNAct_0.Conv_0.weight"),
    ("ffn2_weight", "vit_mamba.ffn.ConvBNAct_1.Conv_0.weight"),
    ("gate1_weight", "attn.Dense_0.weight"),
    ("gate1_bias", "attn.Dense_0.bias"),
    ("gate2_weight", "attn.Dense_1.weight"),
    ("gate2_bias", "attn.Dense_1.bias"),
    ("qkv_weight", "attn.qkv.weight"),
    ("qkv_bias", "attn.qkv.bias"),
    ("attn_dw_weight", "attn.conv.weight"),
    ("attn_dw_bias", "attn.conv.bias"),
)
# Each branch's own projection.
_PROJ = {"height_block": "proj_h_weight", "width_block": "proj_w_weight",
         "channel_block": "proj_c_weight"}
# (fused BatchNorm, the branch's BatchNorm) concatenated over channels.
_BNS = (
    ("bn1", "vit_mamba.dwconv1.BatchNorm_0"),
    ("bn2", "vit_mamba.dwconv2.BatchNorm_0"),
    ("ffn_bn1", "vit_mamba.ffn.ConvBNAct_0.BatchNorm_0"),
    ("ffn_bn2", "vit_mamba.ffn.ConvBNAct_1.BatchNorm_0"),
)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _prefixes(sd, marker: str) -> list[str]:
    return sorted({k[:k.index(marker)] for k in sd if marker in k})


def fuse_direction_params(sd: dict) -> dict:
    """The state dict ``sd`` with every EnhancedViMBlock in the separate
    layout (keys ``<p>height_block.``, ``<p>width_block.``,
    ``<p>channel_block.``) moved to the fused one (``<p>directions.``);
    the other keys as they are. A BatchNorm's ``num_batches_tracked`` is
    the height branch's."""
    out = dict(sd)
    for p in _prefixes(sd, "height_block."):
        key = lambda b, k: f"{p}{b}.{k}"  # noqa: E731
        for b in BRANCHES:
            for k in [k for k in out if k.startswith(f"{p}{b}.")]:
                del out[k]
        d = f"{p}directions."
        for b, name in _PROJ.items():
            out[d + name] = sd[key(b, "proj.weight")]
        for name, k in _STACKED:
            out[d + name] = torch.stack([sd[key(b, k)] for b in BRANCHES])
        for name, k in _BNS:
            for leaf in _BN_LEAVES:
                out[f"{d}{name}.{leaf}"] = torch.cat([sd[key(b, f"{k}.{leaf}")] for b in BRANCHES])
            out[f"{d}{name}.num_batches_tracked"] = sd[key(BRANCHES[0],
                                                           f"{k}.num_batches_tracked")]
    return out


def unfuse_direction_params(sd: dict) -> dict:
    """The inverse of ``fuse_direction_params``: every ``<p>directions.``
    block back to the separate layout, bit for bit."""
    out = dict(sd)
    for p in _prefixes(sd, "directions."):
        d = f"{p}directions."
        for k in [k for k in out if k.startswith(d)]:
            del out[k]
        for i, b in enumerate(BRANCHES):
            key = lambda k: f"{p}{b}.{k}"  # noqa: E731
            out[key("proj.weight")] = sd[d + _PROJ[b]]
            for name, k in _STACKED:
                out[key(k)] = sd[d + name][i]
            for name, k in _BNS:
                for leaf in _BN_LEAVES:
                    out[key(f"{k}.{leaf}")] = sd[f"{d}{name}.{leaf}"].chunk(G)[i]
                out[key(f"{k}.num_batches_tracked")] = sd[f"{d}{name}.num_batches_tracked"]
    return out


class StackedBranches(nn.Module):
    """Three copies of ``make()``'s module held as stacked leaves: each of its
    parameters and buffers (state-dict key k) is one tensor with a leading
    axis of 3 under the same key, as ``nn.vmap`` stores them. Copy i runs
    on ``xs[i]`` (``torch.func.functional_call`` with slice i); a
    BatchNorm's running statistics move in their slice. The module tree that
    holds the stacks is plain containers, so that no per-layer init touches
    a stacked leaf: ``init_weights_`` initialises each copy as a model's
    init would a lone module and stacks them."""

    def __init__(self, make: Callable[[], nn.Module]):
        super().__init__()
        self._make = make
        self.__dict__["_template"] = make()  # unregistered: its tensors are never read
        for k, v in self._template.state_dict(keep_vars=True).items():
            self._put(k, torch.stack([v.detach().clone() for _ in range(G)]),
                      isinstance(v, nn.Parameter))

    def _put(self, key: str, value: torch.Tensor, param: bool) -> None:
        *path, leaf = key.split(".")
        node = self
        for name in path:
            if not hasattr(node, name):
                node.add_module(name, nn.Module())
            node = getattr(node, name)
        if param:
            node.register_parameter(leaf, nn.Parameter(value))
        else:
            node.register_buffer(leaf, value)

    def _leaves(self) -> dict[str, torch.Tensor]:
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        copies = [init_module_(self._make(), generator).state_dict() for _ in range(G)]
        for k, v in self._leaves().items():
            v.copy_(torch.stack([c[k] for c in copies]))

    def forward(self, xs, *args, **kwargs):
        self._template.train(self.training)
        leaves = self._leaves()
        outs = [torch.func.functional_call(self._template, {k: v[i] for k, v in leaves.items()},
                                           (xs[i], *args), kwargs)
                for i in range(G)]
        return torch.stack(outs)
