#!/usr/bin/env python3
"""Times K3a, the HSM-SSD mixer ablation (``kmunet_tpu_torch/kernels/
ablate_mix.py``, CUDA in ``csrc/hsmssd_ablate.cu``), mode by mode, beside
the port's K2 (``hsmssd_compress``) at the same shape: the port of
``scripts/ablate_mix_kernel.py``, with its command line.

    python3 scripts/torch_ablate_mix_kernel.py [full bf16_e no_max no_exp dma_only] [tile=4096]

At the TPU script's shape: B=64, C=16, L=128^2, N=64, bf16, tiles of 4096
tokens (``run`` takes another batch, size and device). For each
mode one line: ms per call by ``kmunet_tpu_torch.utils.chained_time_ms``
(CUDA events over chained calls, each call's xt perturbed by the previous
result as the JAX helper does), the byte bound (xt, dt, Bm, Cm read once, y
written once, at 3.35 TB/s) and ms per token (per ms / (B L)); then the same
for K2 on the same tokens in its own layout ((B, N, L), copies made before
timing). The inputs are N(0, 1) and A U(1, 16), each drawn from its own
``torch.Generator``; the TPU script draws dt, Bm and Cm from one key, so
there they are one array (the timing does not depend on it). Runs on the
card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmunet_tpu_torch.kernels import ablate_mix, ssd  # noqa: E402
from kmunet_tpu_torch.utils import chained_time_ms  # noqa: E402

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
C, N = 16, 64  # KM_UNetV3's enc1 width and the mixers' state size


def byte_bound_ms(B, C, L, N, esz=2) -> float:
    """xt, dt, Bm, Cm read once and y written once, over the HBM rate."""
    return (2 * B * C * L + 3 * B * L * N) * esz / H100_BYTES_PER_S * 1e3


def run(modes=ablate_mix.MODES, tile=4096, batch=64, hw=128, iters=20, device="cuda") -> dict:
    """{mode: (ms, bound_ms, ms per token)} of K3a's ``modes`` and of K2
    ("K2") at (batch, C, hw^2, N), printing a line for each."""
    device = torch.device(device)
    B, L = batch, hw * hw
    tile = min(tile, L)

    def draw(shape, seed, lo=None):
        g = torch.Generator(device=device).manual_seed(seed)
        if lo is None:
            t = torch.randn(shape, generator=g, device=device)
        else:
            t = lo + (16.0 - lo) * torch.rand(shape, generator=g, device=device)
        return t.to(torch.bfloat16)

    xt, dt, Bm, Cm = (draw(s, i) for i, s in enumerate(((B, C, L), (B, L, N), (B, L, N),
                                                         (B, L, N))))
    A = draw((N,), 4, lo=1.0)
    bound = byte_bound_ms(B, C, L, N)
    out = {}
    for mode in modes:
        ms = chained_time_ms(lambda *a, mode=mode: ablate_mix.ablate_mix(mode, *a, tile),
                             xt, dt, Bm, Cm, A, iters=iters)
        out[mode] = (ms, bound, ms / (B * L))
        print(f"{mode:10s} TILE={tile}: {ms:.4f} ms  H100 bound {bound:.4f} ms (bytes)  "
              f"{ms / (B * L):.3e} ms/token", flush=True)
    # K2 in the mixer's layout: dt and B (B, N, L).
    dt_n, bm_n = dt.transpose(1, 2).contiguous(), Bm.transpose(1, 2).contiguous()
    compress = ssd.hsmssd_compress_forward if device.type == "cuda" else ssd.hsmssd_compress_plain
    ms = chained_time_ms(compress, xt, dt_n, bm_n, A.float(), iters=iters)
    k2_bound = ((B * C * L + 2 * B * N * L + B * N * C) * 2 + N * 4) / H100_BYTES_PER_S * 1e3
    out["K2"] = (ms, k2_bound, ms / (B * L))
    print(f"{'K2':10s} compress: {ms:.4f} ms  H100 bound {k2_bound:.4f} ms (bytes)  "
          f"{ms / (B * L):.3e} ms/token", flush=True)
    return out


def main(argv) -> int:
    modes = [a for a in argv if "=" not in a] or list(ablate_mix.MODES)
    tile = 4096
    for a in argv:
        if a.startswith("tile="):
            tile = int(a.split("=")[1])
    if not torch.cuda.is_available():
        print("torch_ablate_mix_kernel: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    run(modes, tile)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
