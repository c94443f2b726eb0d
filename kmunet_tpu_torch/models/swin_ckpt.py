"""Swin-UNet pretrained-checkpoint surgery (port of
``kmunet_tpu/models/swin_ckpt.py``, the reference's ``load_from``) into the
port's SwinUNet.

- A checkpoint with a ``"model"`` entry (the ImageNet swin-tiny release) is
  encoder-only: every encoder key ``layers.N...`` is also mirrored into the
  decoder at ``layers_up.(3-N)...``;
- a checkpoint without one is a full-model dump whose keys carry the
  ``"module.swin_unet."`` prefix, stripped where present, and whose
  ``output`` head keys are dropped;
- shape mismatches are skipped and unknown keys ignored (the reference's
  ``strict=False``): the 3-channel ImageNet ``patch_embed`` against the
  5-frame stem, or a window-7 bias table against window 8.

The reference's torch layouts are the port's, so a value loads as it is;
the report names shapes in the JAX package's flax layouts, so that it reads
as the JAX loader's: ``{"loaded", "shape_mismatch", "unmatched"}``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_NORM = {"weight": "weight", "bias": "bias"}
_BLOCK = {
    "norm1.weight": ("norm1.weight", "direct"), "norm1.bias": ("norm1.bias", "direct"),
    "norm2.weight": ("norm2.weight", "direct"), "norm2.bias": ("norm2.bias", "direct"),
    "attn.qkv.weight": ("attn.qkv.weight", "linear"),
    "attn.qkv.bias": ("attn.qkv.bias", "direct"),
    "attn.proj.weight": ("attn.proj.weight", "linear"),
    "attn.proj.bias": ("attn.proj.bias", "direct"),
    "attn.relative_position_bias_table": ("attn.relative_position_bias_table", "direct"),
    "mlp.fc1.weight": ("fc1.weight", "linear"), "mlp.fc1.bias": ("fc1.bias", "direct"),
    "mlp.fc2.weight": ("fc2.weight", "linear"), "mlp.fc2.bias": ("fc2.bias", "direct"),
}
# (pattern, the port's key with \\1.. filled in, kind)
_RULES = [
    (r"patch_embed\.proj\.weight", "patch_embed.weight", "conv"),
    (r"patch_embed\.proj\.bias", "patch_embed.bias", "direct"),
    (r"patch_embed\.norm\.(weight|bias)", r"patch_norm.\1", "direct"),
    (r"norm\.(weight|bias)", r"norm.\1", "direct"),
    (r"norm_up\.(weight|bias)", r"norm_up.\1", "direct"),
    (r"up\.expand\.weight", "final_expand.expand.weight", "linear"),
    (r"up\.norm\.(weight|bias)", r"final_expand.norm.\1", "direct"),
    (r"output\.weight", "output.weight", "conv"),
    (r"layers\.(\d)\.downsample\.norm\.(weight|bias)", r"merge\1.norm.\2", "direct"),
    (r"layers\.(\d)\.downsample\.reduction\.weight", r"merge\1.reduction.weight", "linear"),
    (r"layers_up\.0\.expand\.weight", "up0.expand.weight", "linear"),
    (r"layers_up\.0\.norm\.(weight|bias)", r"up0.norm.\1", "direct"),
    (r"layers_up\.(\d)\.upsample\.expand\.weight", r"up\1.expand.weight", "linear"),
    (r"layers_up\.(\d)\.upsample\.norm\.(weight|bias)", r"up\1.norm.\2", "direct"),
    (r"concat_back_dim\.(\d)\.weight", r"concat_back_dim\1.weight", "linear"),
    (r"concat_back_dim\.(\d)\.bias", r"concat_back_dim\1.bias", "direct"),
]


def translate(key: str):
    """A reference SwinTransformerSys state_dict key -> (the port's key,
    kind: 'linear', 'conv' or 'direct'), or (None, None) for buffers, heads
    and keys with no counterpart."""
    if ("relative_position_index" in key or "attn_mask" in key
            or key.startswith("head.") or key.startswith("absolute_pos_embed")):
        return None, None
    for pattern, ours, kind in _RULES:
        m = re.fullmatch(pattern, key)
        if m:
            return m.expand(ours), kind
    m = re.fullmatch(r"layers\.(\d)\.blocks\.(\d+)\.(.+)", key)
    prefix = "enc{}_blk{}"
    if m is None:
        m = re.fullmatch(r"layers_up\.(\d)\.blocks\.(\d+)\.(.+)", key)
        prefix = "dec{}_blk{}"
    if m is None or m.group(3) not in _BLOCK:
        return None, None
    sub, kind = _BLOCK[m.group(3)]
    return prefix.format(m.group(1), m.group(2)) + "." + sub, kind


def _flax_shape(shape, kind: str) -> tuple:
    """A torch-layout shape as the JAX package's loader reports it."""
    shape = tuple(shape)
    if kind == "linear":
        return shape[::-1]
    if kind == "conv":
        return tuple(shape[i] for i in (2, 3, 1, 0))
    return shape


@torch.no_grad()
def load_swin_state_dict(model: nn.Module, state_dict: Mapping, n_layers: int = 4):
    """Applies the reference's ``load_from`` surgery to the port's SwinUNet
    ``model`` in place. ``state_dict``: the torch checkpoint dict (with or
    without a ``"model"`` entry) or an unwrapped key -> tensor or array
    mapping. Returns ``(model, report)``, ``report = {"loaded": [...],
    "shape_mismatch": [...], "unmatched": [...]}``."""
    if "model" in state_dict:
        src = dict(state_dict["model"])
        for k, v in list(src.items()):
            if k.startswith("layers."):
                src.setdefault(f"layers_up.{n_layers - 1 - int(k[7])}" + k[8:], v)
    else:
        pre = "module.swin_unet."
        src = {(k[len(pre):] if k.startswith(pre) else k): v for k, v in state_dict.items()}
        src = {k: v for k, v in src.items() if "output" not in k}
    target = model.state_dict()
    report = {"loaded": [], "shape_mismatch": [], "unmatched": []}
    for key, val in src.items():
        ours, kind = translate(key)
        if ours is None or ours not in target:
            report["unmatched"].append(key)
            continue
        val = torch.as_tensor(np.asarray(val))
        cur = target[ours]
        if tuple(val.shape) != tuple(cur.shape):
            report["shape_mismatch"].append(
                f"{key}: ckpt {_flax_shape(val.shape, kind)} vs model "
                f"{_flax_shape(cur.shape, kind)}")
            continue
        cur.copy_(val)
        report["loaded"].append(key)
    return model, report


def load_swin_checkpoint(model: nn.Module, path: str):
    """``load_swin_state_dict`` of the ``.pth`` checkpoint at ``path``
    (``torch.load(weights_only=True)``: tensors and containers only)."""
    return load_swin_state_dict(model, torch.load(path, map_location="cpu", weights_only=True))
