"""LPIPS (AlexNet) perceptual metric (port of ``kmunet_tpu/metrics/lpips.py``).

The reference evaluator uses ``lpips.LPIPS(net='alex')`` with pretrained
ImageNet + LPIPS weights downloaded from the net. They cannot be fetched
here: this module is the architecture, and its weights come from a local
``.npz`` in the JAX package's layout (HWIO convs), written by
``convert_torch_lpips`` from a torch ``lpips`` state_dict. Without weights
the Evaluator reports LPIPS as NaN with a status that says so.

lpips v0.1 'alex':
    x -> (x - shift) / scale               per-channel normalization
    5 AlexNet feature stages (conv + ReLU, 3x3 stride-2 max pools between)
    per stage: unit-normalize the channels, d = (f1 - f2)^2, a 1x1 conv
    (lin_k), the spatial mean; LPIPS is the sum over the stages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.serve import resolve_device

# AlexNet's feature convs: (out_ch, kernel, stride, pad), 'M' = max pool 3x3 stride 2.
_ALEX_CFG = [
    (64, 11, 4, 2), "M",
    (192, 5, 1, 2), "M",
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """LPIPS-alex over (N, 3, H, W) images in [-1, 1]: ``forward(x1, x2)``
    is the (N,) distance. Its parameters are named as the npz's keys
    (``conv{i}_w`` OIHW, ``conv{i}_b``, ``lin{i}_w`` (1, C, 1, 1))."""

    def __init__(self):
        super().__init__()
        convs = [c for c in _ALEX_CFG if c != "M"]
        in_ch = 3
        for i, (out_ch, k, _, _) in enumerate(convs):
            self.register_parameter(f"conv{i}_w", nn.Parameter(torch.zeros(out_ch, in_ch, k, k)))
            self.register_parameter(f"conv{i}_b", nn.Parameter(torch.zeros(out_ch)))
            self.register_parameter(f"lin{i}_w", nn.Parameter(torch.zeros(1, out_ch, 1, 1)))
            in_ch = out_ch
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The 5 ReLU feature maps of (N, 3, H, W) images in [-1, 1]."""
        x = (x - self.shift) / self.scale
        feats = []
        ci = 0
        for item in _ALEX_CFG:
            if item == "M":
                x = F.max_pool2d(x, 3, 2)
                continue
            _, _, s, p = item
            x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_w"), getattr(self, f"conv{ci}_b"),
                                stride=s, padding=p))
            feats.append(x)
            ci += 1
        return feats

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x1), self.features(x2))):
            an = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
            bn = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
            d = F.conv2d((an - bn) ** 2, getattr(self, f"lin{i}_w"))
            total = total + d.mean(dim=(2, 3))[:, 0]
        return total


def load_lpips_params(path: str) -> dict:
    """The npz's arrays, in the JAX package's layout (HWIO convs)."""
    data = np.load(path)
    return {k: np.asarray(v) for k, v in data.items()}


def make_lpips_fn(weights_path: Optional[str] = None, device=None):
    """An Evaluator ``lpips_fn(pred, true)``: (B, T) distances of (B, T, H,
    W) frames in [0, 1], each repeated to 3 channels, by ``LPIPS`` on
    ``device`` (None: the card, which must exist) with the npz's weights;
    None without weights."""
    if weights_path is None:
        return None
    model = LPIPS()
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
        for k, v in load_lpips_params(weights_path).items()})
    model = model.to(resolve_device(device)).eval()

    @torch.no_grad()
    def fn(pred, true):
        B, T = pred.shape[:2]

        def prep(x):
            x = x.reshape(B * T, 1, *x.shape[2:]).float().to(model.shift.device)
            return x.expand(-1, 3, -1, -1) * 2.0 - 1.0

        return model(prep(pred), prep(true)).reshape(B, T)

    return fn


# lpips v0.1 'alex' state_dict keys: the package names each slice's
# children by their index in torchvision's AlexNet features, so the 5 convs
# sit at these keys.
_TORCH_CONV_KEYS = [
    "net.slice1.0", "net.slice2.3", "net.slice3.6", "net.slice4.8", "net.slice5.10",
]
_TORCH_LIN_KEYS = [f"lin{i}.model.1" for i in range(5)]


def convert_lpips_state_dict(state_dict: dict) -> dict:
    """A torch ``lpips.LPIPS(net='alex')`` state_dict (tensors or arrays) in
    the npz's naming and layout (HWIO convs). It must be the whole module's:
    the official alex.pth holds the lin heads only."""
    def npy(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    params = {}
    for ci, key in enumerate(_TORCH_CONV_KEYS):
        params[f"conv{ci}_w"] = npy(state_dict[f"{key}.weight"]).transpose(2, 3, 1, 0)
        params[f"conv{ci}_b"] = npy(state_dict[f"{key}.bias"])
    for i, key in enumerate(_TORCH_LIN_KEYS):
        params[f"lin{i}_w"] = npy(state_dict[f"{key}.weight"]).transpose(2, 3, 1, 0)
    return params


def convert_torch_lpips(out_path: str, state_dict_path: Optional[str] = None) -> None:
    """Writes the npz of a saved ``LPIPS(net='alex').state_dict()``
    (``state_dict_path``), or of the ``lpips`` package's own weights, which
    it downloads (on a host with the package and the network)."""
    if state_dict_path is not None:
        sd = torch.load(state_dict_path, map_location="cpu")
    else:  # pragma: no cover - needs the lpips package and the network
        import lpips as lpips_pkg

        sd = lpips_pkg.LPIPS(net="alex").state_dict()
    np.savez(out_path, **convert_lpips_state_dict(sd))
