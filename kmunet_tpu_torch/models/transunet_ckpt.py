"""Official R50 + ViT-B/16 ``.npz`` checkpoints into the port's TransUNet
(port of ``kmunet_tpu/models/transunet_ckpt.py``).

The reference's ``VisionTransformer.load_from`` ingests the JAX-format ViT
checkpoints of the original ViT release: flax layouts (HWIO conv kernels,
(in, out) dense kernels, (in, heads, head_dim) attention kernels), which
``convert``'s flax rules take to the port's layouts. Loaded: the patch
embedding, the position embeddings (the class token dropped; the grid
zoomed with the port's own ``data/resize.py::Resizer`` where the patch
grids differ), the transformer's layers and final norm, and with a hybrid
checkpoint the ResNet stem. The decoder is task-specific and keeps its
initialisation, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from kmunet_tpu_torch.convert import convert_leaf
from kmunet_tpu_torch.data.resize import Resizer


def _posembed(stored: np.ndarray, n_patches: int) -> np.ndarray:
    """The stored (1, n, hidden) position embeddings for ``n_patches``: the
    class token dropped, the grid zoomed where it differs."""
    if stored.shape[1] == n_patches + 1:
        stored = stored[:, 1:]
    if stored.shape[1] == n_patches:
        return stored
    old, new = int(math.sqrt(stored.shape[1])), int(math.sqrt(n_patches))
    grid = stored.reshape(old, old, -1)
    # Resizer works on (..., H, W): channels first
    zoomed = Resizer((old, old), (new, new))(np.moveaxis(grid, -1, 0)).transpose(1, 2, 0)
    return zoomed.reshape(1, new * new, -1)


def _entries(w, n_layers: int):
    """(flax path in the port's tree, array) of each checkpoint entry the
    reference loads."""
    yield ("patch_embeddings", "kernel"), w["embedding/kernel"]
    yield ("patch_embeddings", "bias"), w["embedding/bias"]
    yield ("encoder_norm", "scale"), w["Transformer/encoder_norm/scale"]
    yield ("encoder_norm", "bias"), w["Transformer/encoder_norm/bias"]
    for i in range(n_layers):
        root = f"Transformer/encoderblock_{i}"
        att = f"{root}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value", "out"):
            for leaf in ("kernel", "bias"):
                yield (f"block{i}", "attn", name, leaf), w[f"{att}/{name}/{leaf}"]
        for ours, theirs in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            for leaf in ("kernel", "bias"):
                yield (f"block{i}", ours, leaf), w[f"{root}/MlpBlock_3/{theirs}/{leaf}"]
        for ours, theirs in (("attention_norm", "LayerNorm_0"), ("ffn_norm", "LayerNorm_2")):
            for leaf in ("scale", "bias"):
                yield (f"block{i}", ours, leaf), w[f"{root}/{theirs}/{leaf}"]
    if "conv_root/kernel" not in w:
        return
    yield ("hybrid_model", "root_conv", "kernel"), w["conv_root/kernel"]
    yield ("hybrid_model", "root_gn", "scale"), w["gn_root/scale"].reshape(-1)
    yield ("hybrid_model", "root_gn", "bias"), w["gn_root/bias"].reshape(-1)
    for b, n_units in {1: 3, 2: 4, 3: 9}.items():
        for u in range(1, n_units + 1):
            src, dst = f"block{b}/unit{u}", f"block{b}_unit{u}"
            for conv in ("conv1", "conv2", "conv3"):
                yield ("hybrid_model", dst, conv, "kernel"), w[f"{src}/{conv}/kernel"]
            for gn in ("gn1", "gn2", "gn3"):
                for leaf in ("scale", "bias"):
                    yield ("hybrid_model", dst, gn, leaf), w[f"{src}/{gn}/{leaf}"].reshape(-1)
            if f"{src}/conv_proj/kernel" in w:
                yield ("hybrid_model", dst, "downsample", "kernel"), w[f"{src}/conv_proj/kernel"]
                for leaf in ("scale", "bias"):
                    yield (("hybrid_model", dst, "gn_proj", leaf),
                           w[f"{src}/gn_proj/{leaf}"].reshape(-1))


@torch.no_grad()
def load_vit_npz(model: nn.Module, npz_path: str, n_layers: int = 12) -> nn.Module:
    """Loads the ViT (and R50 stem) weights of ``npz_path`` into the
    TransUNet ``model`` in place and returns it. Raises ``ValueError`` on a
    shape that does not match the model's and ``KeyError`` on a missing
    entry."""
    w = dict(np.load(npz_path))
    target = model.state_dict()
    entries = list(_entries(w, n_layers))
    n_patches = target["position_embeddings"].shape[1]
    entries.append((("position_embeddings",),
                    _posembed(w["Transformer/posembed_input/pos_embedding"], n_patches)))
    for path, value in entries:
        key, value = convert_leaf(path, np.asarray(value))
        if key not in target:
            raise KeyError(f"{'/'.join(path)}: the model has no {key}")
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: checkpoint {tuple(value.shape)} vs model "
                             f"{tuple(target[key].shape)}")
        target[key].copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return model
