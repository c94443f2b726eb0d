#!/usr/bin/env python3
"""The port's redesigned kernels timed on the card, one CUDA source at a time.

    python3 scripts/torch_kernel_timing.py {gather,kanconv,hsmssd} [--root DIR] [--sass]

Builds the named source of the port found under ``--root`` (a checkout of
this repository; by default the one this script is in) and times its
kernels in bf16 with ``chip_smoke.py``'s timing function for them:

- ``gather``: ``bilinear_gather_multiview_forward`` (K7) at
  ``chip_smoke.MULTIVIEW_TIMING_SHAPES`` (TrajGRU's five K7 shapes at B=16,
  the deformable conv's nine taps at B=128) beside ``F.grid_sample`` and,
  at the bridge, nine ``bilinear_gather_forward`` (K5) calls and
  ``torch.cat``, each K7 output first held to the plain version; and
  ``bilinear_gather_grouped_forward`` (K4) at DySample's dec3,
  ``multiview_timing``;
- ``kanconv``: ``kanconv_forward`` (K1) at ``chip_smoke.KAN_TIMING_SHAPES``
  (SH's four KAN convs at B=128, LAPS's enc1 at B=32), ``kan_timing``;
- ``hsmssd``: ``hsmssd_compress_forward`` (K2) and ``hsmssd_mix_forward``
  (K3) at ``chip_smoke.MIXER_TIMING_SHAPES`` (SH's three mixer shapes at
  B=128, LAPS's enc1 at B=32), ``mixer_timing`` by pass.

Each gives ms over back-to-back calls, queued ms (device time, no host
gap), the profiler's device ms, device launches per call and device ms per
call by kernel, beside the bound. With ``--sass`` it also counts, per
kernel of the built library, the tensor-core instructions (HMMA) in its
SASS (``cuobjdump -sass``). Prints JSON lines, the first the card's
``nvidia-smi`` name and power limit. Needs an NVIDIA GPU; two checkouts
are compared by running it on each, in turns, in one call.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# source name -> (the port's module that builds and launches it, the
# chip_smoke function that times it)
KERNELS = {"gather": ("bilinear", "multiview_timing"), "kanconv": ("kanconv", "kan_timing"),
           "hsmssd": ("ssd", "mixer_timing")}
# the module attributes that name the CUDA sources a module builds
SOURCES = ("SOURCE", "MULTIVIEW_SOURCE")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sass_tensor_core_counts(library: str) -> dict:
    """{kernel: HMMA instructions} from ``cuobjdump -sass`` of ``library``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source", choices=sorted(KERNELS), help="the CUDA source whose kernels are timed")
    parser.add_argument("--root", default=REPO, help="checkout whose kmunet_tpu_torch is timed")
    parser.add_argument("--sass", action="store_true", help="count HMMA per kernel")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    module_name, timing_name = KERNELS[args.source]
    module = importlib.import_module(f"kmunet_tpu_torch.kernels.{module_name}")
    from kmunet_tpu_torch.kernels import build

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip().splitlines()[0]
    emit({"card": card, "root": os.path.relpath(root, REPO), "torch": torch.__version__})
    for source in (getattr(module, name) for name in SOURCES if hasattr(module, name)):
        built = build.build(source)
        emit({"source": source, "nvcc_seconds": built.seconds,
              "ptxas": list(chip_smoke.ptxas_summary(built.compiler_output))})
        if args.sass:
            emit({"hmma_per_kernel": sass_tensor_core_counts(str(built.path))})
    emit({timing_name: getattr(chip_smoke, timing_name)(torch, module)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
