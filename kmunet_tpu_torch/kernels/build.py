"""Build a CUDA source of the port into a shared library.

Each kernel source in ``kmunet_tpu_torch/csrc`` has a plain C interface and
is compiled by one ``nvcc`` call into ``kmunet_tpu_torch/_build/`` at first
use; the caller loads it with ``ctypes``. The library's file name carries a
hash of the source, the headers beside it (``csrc/*.cuh``, which a source
includes by name) and the flags, so a changed source or header is rebuilt. The compiler
writes to a temporary name that is renamed into place, under an ``fcntl``
lock of that source with a deadline, so parallel processes cannot race on one
build while two sources can build at once, and ``nvcc`` itself runs under a
timeout.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300
LOCK_TIMEOUT_S = 360


@dataclass(frozen=True)
class Built:
    """A compiled kernel library and how it was made."""

    path: Path
    seconds: float  # nvcc's wall time; 0.0 when the library was already built
    compiler_output: str  # nvcc's stdout and stderr (the -Xptxas -v report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a CUDA machine")
    return path


def build(source_name: str) -> Built:
    """Compile ``csrc/<source_name>`` unless a library of the same source and
    flags is already built; return where it is."""
    source = CSRC_DIR / source_name
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"{source.stem}_{digest[:16]}.so"
    BUILD_DIR.mkdir(exist_ok=True)
    lock_path = BUILD_DIR / f".{source.stem}.lock"
    with open(lock_path, "w") as lock:
        deadline = time.monotonic() + LOCK_TIMEOUT_S
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"waited {LOCK_TIMEOUT_S} s for {lock_path}")
                time.sleep(0.2)
        try:
            if target.exists():
                return Built(target, 0.0, "")
            tmp = target.with_name(f"{target.stem}.tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            output = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{output}")
            os.replace(tmp, target)
            return Built(target, seconds, output)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
