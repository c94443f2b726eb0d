"""Flax variables (as numpy) -> the port's ``state_dict``.

The port's submodules carry the flax module names, so a flax path maps to a
state_dict key by joining it with dots and renaming its leaf; the layout
changes are:

- a conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw); the
  same permutation takes a ``ConvTranspose(transpose_kernel=True)`` kernel
  (kh, kw, out, in) to ``ConvTranspose2d``'s ``weight`` (in, out, kh, kw),
  with no spatial flip;
- a dense ``kernel`` (in, out) -> ``weight`` (out, in);
- ``scale`` -> ``weight``; BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``;
- KANConv2d's ``base_kernel`` (k, k, C, F) -> ``base_weight`` (F, C, k, k),
  ``spline_kernel`` (k, k, C, n, F) -> ``spline_weight`` (F, C, n, k, k) and
  ``spline_scaler`` (k, k, C, F) -> (F, C, k, k);
- KANLinear's ``base_weight`` (in, out) -> (out, in), ``spline_weight``
  (in, n, out) -> (out, in, n) and ``spline_scaler`` (in, out) -> (out, in);
- HSMSSD's ``BCdt_proj_kernel`` (C, 3N) -> ``BCdt_proj`` (3N, C) and
  ``dw_kernel`` (3, 3, 1, 3N) -> ``dw_weight`` (3N, 1, 3, 3);
- ConvLSTM's per-channel peepholes ``Wci``, ``Wcf``, ``Wco`` keep their names;
- Mamba's ``conv1d_kernel`` (d_conv, 1, d_inner) -> ``conv1d_weight``
  (d_inner, 1, d_conv), ``dt_proj_kernel`` (dt_rank, d_inner) ->
  ``dt_proj_weight`` (d_inner, dt_rank), and Mamba-UNet's
  ``get_all_att_kernel`` (3, 1, 1) -> ``get_all_att_weight`` (1, 1, 3);
  ``conv1d_bias``, ``dt_proj_bias``, ``A_log``, ``skip_scale1/2`` and the 0-d
  ``alpha1..3`` and ``beta`` keep their names;
- the zoo's: ECA's ``conv_kernel`` (k, 1, 1) -> ``conv_weight`` (1, 1, k);
  flax ``MultiHeadDotProductAttention``'s DenseGeneral kernels, ``query``,
  ``key``, ``value`` (in, heads, head_dim) -> ``weight`` (heads * head_dim,
  in) and ``out`` (heads, head_dim, out) -> (out, heads * head_dim), their
  (heads, head_dim) biases flattened; SRU's ``gamma``, LPTQPN's
  SigmoidLayerNorm ``weight``, ``temperature`` and 0-d ``swish_beta``,
  TransUNet's ``position_embeddings`` and Swin's
  ``relative_position_bias_table`` keep their names and shapes;
- the EfficientViM classifier's head weights ``weights`` and
  ``weights_dist`` keep theirs, and so do the KAN variants' own leaves
  (``cheby_coeffs``, ``grams_basis_weights``, WavKAN's 2-D ``scale``, ...);
- EnhancedViMBlock's fused layout (``directions``): each stacked kernel
  (G, kh, kw, in, out) -> (G, out, in, kh, kw), each stacked dense kernel
  (G, in, out) -> (G, out, in), the three projections as convs; its vmap
  layout (``vit_mamba3``, ``attn3``): every leaf stacked on a leading axis
  of 3, each slice converted as the lone leaf.

``to_state_dict`` raises if a flax leaf is left unused or a torch key unfilled.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_OIHW = (3, 2, 0, 1)
# flax leaf name -> (torch leaf name, axis permutation or None)
_RENAMES = {
    "bias": ("bias", None),
    "scale": ("weight", None),
    "mean": ("running_mean", None),
    "var": ("running_var", None),
    "base_kernel": ("base_weight", _OIHW),
    "spline_kernel": ("spline_weight", (4, 2, 3, 0, 1)),
    "spline_scaler": ("spline_scaler", _OIHW),
    "BCdt_proj_kernel": ("BCdt_proj", (1, 0)),
    "dw_kernel": ("dw_weight", _OIHW),
    "alpha": ("alpha", None),
    "A": ("A", None),
    "D": ("D", None),
    "Wci": ("Wci", None),
    "Wcf": ("Wcf", None),
    "Wco": ("Wco", None),
    "conv1d_kernel": ("conv1d_weight", (2, 1, 0)),
    "conv1d_bias": ("conv1d_bias", None),
    "dt_proj_kernel": ("dt_proj_weight", (1, 0)),
    "dt_proj_bias": ("dt_proj_bias", None),
    "A_log": ("A_log", None),
    "skip_scale1": ("skip_scale1", None),
    "skip_scale2": ("skip_scale2", None),
    "get_all_att_kernel": ("get_all_att_weight", (2, 1, 0)),
    "alpha1": ("alpha1", None),
    "alpha2": ("alpha2", None),
    "alpha3": ("alpha3", None),
    "beta": ("beta", None),
    "conv_kernel": ("conv_weight", (2, 1, 0)),
    "gamma": ("gamma", None),
    "weight": ("weight", None),
    "temperature": ("temperature", None),
    "swish_beta": ("swish_beta", None),
    "position_embeddings": ("position_embeddings", None),
    "relative_position_bias_table": ("relative_position_bias_table", None),
    "weights": ("weights", None),
    "weights_dist": ("weights_dist", None),
    "cheby_coeffs": ("cheby_coeffs", None),
    "beta_weights": ("beta_weights", None),
    "grams_basis_weights": ("grams_basis_weights", None),
    "base_weights": ("base_weights", None),
    "translation": ("translation", None),
    "wavelet_weights": ("wavelet_weights", None),
    "weight1": ("weight1", None),
    "jacobi_coeffs": ("jacobi_coeffs", None),
    "phase_low": ("phase_low", None),
    "phase_height": ("phase_height", None),
}
# KANLinear's leaves (its 2-D spline_scaler; KANConv2d's is 4-D, above).
_KAN_LINEAR = {"base_weight": (1, 0), "spline_weight": (2, 0, 1), "spline_scaler": (1, 0)}
# Torch bookkeeping with no flax counterpart; set to 0, never read in eval.
_TORCH_ONLY = "num_batches_tracked"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# FusedDirectionViM's leaves (the flax module ``directions``): flax name ->
# (torch name, axis permutation or None); its BatchNorms take the rules above.
_STACK_OIHW = (0, 4, 3, 1, 2)  # (G, kh, kw, in, out) -> (G, out, in, kh, kw)
_FUSED_VIM = {
    "proj_h_kernel": ("proj_h_weight", _OIHW),
    "proj_w_kernel": ("proj_w_weight", _OIHW),
    "proj_c_kernel": ("proj_c_weight", _OIHW),
    "proj_bias": ("proj_bias", None),
    "alpha": ("alpha", None),
    "dw1_kernel": ("dw1_weight", _STACK_OIHW),
    "ln_scale": ("ln_scale", None),
    "ln_bias": ("ln_bias", None),
    "BCdt_proj_kernel": ("BCdt_proj", (0, 2, 1)),
    "BCdt_dw_kernel": ("BCdt_dw", _STACK_OIHW),
    "A": ("A", None),
    "hz_kernel": ("hz_weight", (0, 2, 1)),
    "D": ("D", None),
    "out_kernel": ("out_weight", (0, 2, 1)),
    "dw2_kernel": ("dw2_weight", _STACK_OIHW),
    "ffn1_kernel": ("ffn1_weight", _STACK_OIHW),
    "ffn2_kernel": ("ffn2_weight", _STACK_OIHW),
    "gate1_kernel": ("gate1_weight", (0, 2, 1)),
    "gate1_bias": ("gate1_bias", None),
    "gate2_kernel": ("gate2_weight", (0, 2, 1)),
    "gate2_bias": ("gate2_bias", None),
    "qkv_kernel": ("qkv_weight", _STACK_OIHW),
    "qkv_bias": ("qkv_bias", None),
    "attn_dw_kernel": ("attn_dw_weight", _STACK_OIHW),
    "attn_dw_bias": ("attn_dw_bias", None),
}
# The modules ``nn.vmap`` stacks (EnhancedViMBlock's "vmap" layout): each of
# their leaves has a leading axis of 3, whose slices convert as a lone leaf.
_VMAPPED = ("vit_mamba3", "attn3")


def convert_leaf(path, value, sliced: bool = False):
    """(the port's state_dict key, the value in its layout) of the flax leaf
    at ``path`` (a tuple of names) holding ``value``; ``sliced``: one slice
    of a vmapped module's stacked leaf."""
    *mods, leaf = path
    if not sliced and any(m in _VMAPPED for m in mods):
        parts = [convert_leaf(path, v, sliced=True) for v in value]
        return parts[0][0], np.stack([p[1] for p in parts])
    if mods and mods[-1] == "directions" and leaf in _FUSED_VIM:
        name, perm = _FUSED_VIM[leaf]
        return ".".join((*mods, name)), value if perm is None else value.transpose(perm)
    if leaf == "kernel" and value.ndim == 3:  # a DenseGeneral of attention
        flat = value.reshape(-1, value.shape[-1]) if mods[-1] == "out" else value.reshape(
            value.shape[0], -1)
        return ".".join((*mods, "weight")), flat.T
    if leaf == "bias" and value.ndim == 2:
        return ".".join((*mods, "bias")), value.reshape(-1)
    if leaf == "kernel":
        perm = _OIHW if value.ndim == 4 else (1, 0)
        name = "weight"
    elif leaf in _KAN_LINEAR and value.ndim == len(_KAN_LINEAR[leaf]):
        name, perm = leaf, _KAN_LINEAR[leaf]
    elif leaf == "scale" and value.ndim == 2:  # WavKANLayer's (out, in) scales
        name, perm = leaf, None
    elif leaf in _RENAMES:
        name, perm = _RENAMES[leaf]
    else:
        raise KeyError(f"no conversion rule for flax leaf {'/'.join(path)}")
    if perm is not None:
        value = value.transpose(perm)
    return ".".join((*mods, name)), value


def flax_permutation(key: str, ndim: int):
    """The axis permutation that took the flax leaf of the port's ``key`` (a
    parameter of ``ndim`` dims) to its torch layout: torch axis i is flax
    axis ``perm[i]``; None where the layouts agree."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight":  # a conv or dense ``kernel``, or a norm's ``scale``
        return _OIHW if ndim == 4 else (1, 0) if ndim == 2 else None
    if leaf in _KAN_LINEAR and ndim == len(_KAN_LINEAR[leaf]):
        return _KAN_LINEAR[leaf]
    for name, perm in _RENAMES.values():
        if name == leaf:
            return perm
    return None


def to_state_dict(model: nn.Module, params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """The state_dict for ``model`` from flax ``params`` and ``batch_stats``
    (nested mappings of arrays). Raises KeyError on a flax leaf with no
    torch key, a torch key with no flax leaf, and ValueError on a shape
    mismatch."""
    target = model.state_dict()
    out = {}
    unused = []
    leaves = list(_flatten(params)) + list(_flatten(batch_stats or {}))
    for path, value in leaves:
        key, value = convert_leaf(path, value)
        if key not in target:
            unused.append("/".join(path))
            continue
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: flax {value.shape} -> torch {tuple(target[key].shape)}")
        # ascontiguousarray makes a 0-d leaf (Mamba-UNet's alpha1..3, beta) 1-d.
        value = np.ascontiguousarray(value).reshape(value.shape)
        out[key] = torch.from_numpy(value).to(target[key].dtype)
    for key in target:
        if key.endswith(_TORCH_ONLY):
            out[key] = torch.zeros_like(target[key])
    unfilled = sorted(set(target) - set(out))
    if unused or unfilled:
        raise KeyError(f"unused flax leaves: {unused}; unfilled torch keys: {unfilled}")
    return out


def load_flax(model: nn.Module, params: Mapping, batch_stats: Mapping | None = None) -> nn.Module:
    """Load converted flax variables into ``model`` (strictly) and return it."""
    model.load_state_dict(to_state_dict(model, params, batch_stats), strict=True)
    return model
