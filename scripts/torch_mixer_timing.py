#!/usr/bin/env python3
"""K2 and K3, the HSM-SSD mixer kernels, timed by pass on the card.

    python3 scripts/torch_mixer_timing.py [--root DIR] [--sass] [--repeat N]

Times ``hsmssd_compress_forward`` (K2) and ``hsmssd_mix_forward`` (K3) of
the port found under ``--root`` (a checkout of this repository; by default
the one this script is in), in bf16 at ``chip_smoke.MIXER_TIMING_SHAPES``
(SH's three mixer shapes at B=128, LAPS's enc1 at B=32), with
``chip_smoke.mixer_timing``: ms over back-to-back calls, queued ms (device
time, no host gap), the profiler's device ms, device launches per call and
device ms per call by kernel, beside the bound. ``--repeat`` runs the
whole timing N times (the spread between runs). With ``--sass`` it also
counts, per kernel of the built ``csrc/hsmssd.cu`` library, the tensor-core
instructions (HMMA) in its SASS (``cuobjdump -sass``). Prints JSON lines,
the first the card's ``nvidia-smi`` name and power limit. Needs an NVIDIA
GPU; two checkouts are compared by running it on each, in turns, in one
call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    parser.add_argument("--root", default=REPO, help="checkout whose kmunet_tpu_torch is timed")
    parser.add_argument("--sass", action="store_true", help="count HMMA per kernel")
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_mixer_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from kmunet_tpu_torch.kernels import build, ssd

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip().splitlines()[0]
    emit({"card": card, "root": os.path.relpath(root, REPO), "torch": torch.__version__})
    built = build.build(ssd.SOURCE)
    emit({"nvcc_seconds": built.seconds,
          "ptxas": list(chip_smoke.ptxas_summary(built.compiler_output))})
    if args.sass:
        emit({"hmma_per_kernel": sass_tensor_core_counts(str(built.path))})
    for i in range(args.repeat):
        emit({"run": i, "mixer_timing": chip_smoke.mixer_timing(torch, ssd)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
