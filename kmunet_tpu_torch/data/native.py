"""The host-side loader core (``csrc/km_loader.cc``): build, load and
ctypes bindings (port of ``kmunet_tpu/native/__init__.py``).

The source is the port's own copy. It is compiled on first use with g++
into ``kmunet_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, written to a temporary name and renamed into place,
so concurrent builders race harmlessly. Without a toolchain every entry
point returns None, and ``data/resize.py`` takes its numpy path (the same
arithmetic as two dense matmuls). Calls release the GIL (plain ctypes), so
the DataLoader's worker threads overlap on a multi-core host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "km_loader.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_tried = False


def _build() -> Optional[Path]:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"km_loader_{digest[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
        return target
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def load() -> Optional[ctypes.CDLL]:
    """The loader library, built on the first call; None if it cannot be."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    common = [f32p, i32p, ctypes.c_long, ctypes.c_long,
              f32p, i32p, ctypes.c_long, ctypes.c_long, f32p, f32p]
    lib.km_resize_u8.restype = None
    lib.km_resize_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_long, ctypes.c_long, ctypes.c_long] + common
    lib.km_resize_f32.restype = None
    lib.km_resize_f32.argtypes = [f32p, ctypes.c_long, ctypes.c_long, ctypes.c_long] + common
    _lib = lib
    return _lib


def to_banded(W: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense (out, in) filter matrix -> (vals (out, max_taps), starts (out,)).

    The triangle filter's rows have contiguous support; starts are shifted
    left so that every ``max_taps`` window fits inside the input (the C++
    inner loops never bounds-check), with the weights zero-padded into
    place."""
    out_size, in_size = W.shape
    nz = W != 0
    max_t = min(max(int(nz.sum(axis=1).max()), 1), in_size)
    vals = np.zeros((out_size, max_t), np.float32)
    starts = np.zeros(out_size, np.int32)
    for i in range(out_size):
        idx = np.flatnonzero(nz[i])
        if len(idx) == 0:
            continue
        s = min(int(idx[0]), in_size - max_t)
        vals[i, idx - s] = W[i, idx]
        starts[i] = s
    return vals, starts


def banded_resize(src: np.ndarray, wh: np.ndarray, hstart: np.ndarray, ww: np.ndarray,
                  wstart: np.ndarray) -> Optional[np.ndarray]:
    """Separable banded resize of (..., H, W) uint8 or float32 frames to
    (..., Ho, Wo) float32; None when the library is unavailable, or the
    frames do not fit the weights or have another dtype (the caller's numpy
    path then raises cleanly or computes it)."""
    lib = load()
    if lib is None:
        return None
    lead = src.shape[:-2]
    H, W = src.shape[-2:]
    wh, ww = (np.ascontiguousarray(a, np.float32) for a in (wh, ww))
    hstart, wstart = (np.ascontiguousarray(a, np.int32) for a in (hstart, wstart))
    # The inner loops read start + max_taps inputs unchecked.
    if (H < int(hstart.max()) + wh.shape[1] or W < int(wstart.max()) + ww.shape[1]
            or hstart.min() < 0 or wstart.min() < 0):
        return None
    if src.dtype not in (np.uint8, np.float32):
        return None
    Ho, max_th = wh.shape
    Wo, max_tw = ww.shape
    x = np.ascontiguousarray(src.reshape(-1, H, W))
    out = np.empty((x.shape[0], Ho, Wo), np.float32)
    tmp = np.empty((Ho, W), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    args = (ctypes.c_long(x.shape[0]), ctypes.c_long(H), ctypes.c_long(W),
            wh.ctypes.data_as(f32p), hstart.ctypes.data_as(i32p),
            ctypes.c_long(max_th), ctypes.c_long(Ho),
            ww.ctypes.data_as(f32p), wstart.ctypes.data_as(i32p),
            ctypes.c_long(max_tw), ctypes.c_long(Wo),
            out.ctypes.data_as(f32p), tmp.ctypes.data_as(f32p))
    if x.dtype == np.uint8:
        lib.km_resize_u8(x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *args)
    else:
        lib.km_resize_f32(x.ctypes.data_as(f32p), *args)
    return out.reshape(*lead, Ho, Wo)
