"""ctypes binding to the port's host C++ event engine (csrc/events.cpp).

Port of benerf_tpu/data/_native.py. The library is built from the source in
the checkout with the host C++ compiler (g++, which nvcc needs on the card
machine too) into benerf_tpu_torch/_build/ at first use through the kernels'
build (core/libbuild.py), so concurrent test workers do not race. A build
or load that fails raises: nothing falls back to numpy (the JAX binding
does so silently). The numpy versions stay beside it as the plain
versions the tests hold it against (prepare_events_numpy here;
events.accumulate_events_numpy; np.searchsorted).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

import numpy as np

from benerf_tpu_torch.core import libbuild

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "events.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lock = threading.Lock()
_lib = None

_i32, _i64 = ctypes.c_int32, ctypes.c_int64
_f32p, _f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
_i32p, _i64p = ctypes.POINTER(_i32), ctypes.POINTER(_i64)
_API = {
    "accumulate_events": ([_f64p, _i32p, _i32p, _f32p, _i64, _i32], None),
    "time_window": ([_f32p, _i64, ctypes.c_float, ctypes.c_float, _i64p,
                     _i64p], None),
    "prepare_events": ([_f64p, _f64p, _f64p, _f64p, _i64, _i32,
                        ctypes.c_double, ctypes.c_double, _i32p, _f32p,
                        _f32p], _i64),
}


def build() -> Path:
    """Compile csrc/events.cpp unless its current library exists; returns
    the library's path. Raises when no compiler is found or it fails."""
    target = libbuild.library_path(BUILD_DIR, "benerf_events", CXX_FLAGS,
                                   [SOURCE])
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++): the event engine "
                           "cannot be built")
    libbuild.compile_libraries(
        [("events", [cxx, *CXX_FLAGS, str(SOURCE)], target)], "event engine")
    return target


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (argtypes, restype) in _API.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def accumulate_events(x, y, pol, height: int, width: int) -> np.ndarray:
    """Deterministic polarity scatter-add -> (H, W) float64."""
    x = np.ascontiguousarray(x, np.int32)
    y = np.ascontiguousarray(y, np.int32)
    pol = np.ascontiguousarray(pol, np.float32)
    if x.shape != y.shape or x.shape != pol.shape:
        raise ValueError(f"x, y, pol shapes differ: {x.shape} {y.shape} "
                         f"{pol.shape}")
    if x.size and not (0 <= x.min() and x.max() < width
                       and 0 <= y.min() and y.max() < height):
        raise ValueError(f"event coordinates outside {height}x{width}")
    out = np.zeros((height, width), np.float64)
    _load().accumulate_events(_ptr(out, ctypes.c_double), _ptr(x, _i32),
                              _ptr(y, _i32), _ptr(pol, ctypes.c_float),
                              len(x), width)
    return out


def time_window(ts, t0: float, t1: float):
    """(lo, hi) index range with t0 <= ts <= t1 over a sorted array."""
    ts = np.ascontiguousarray(ts, np.float32)
    lo, hi = _i64(), _i64()
    _load().time_window(_ptr(ts, ctypes.c_float), len(ts), t0, t1,
                        ctypes.byref(lo), ctypes.byref(hi))
    return int(lo.value), int(hi.value)


def prepare_events(x, y, t, p, width: int, t_lo: float, t_hi: float):
    """Filter to [t_lo, t_hi], normalize ts over it, flatten pixels, stable
    sort by time. Returns (pix_idx int32, ts float32 in [0,1], pol
    float32)."""
    x, y, t, p = (np.ascontiguousarray(a, np.float64) for a in (x, y, t, p))
    if not x.shape == y.shape == t.shape == p.shape:
        raise ValueError(f"x, y, t, p shapes differ: {x.shape} {y.shape} "
                         f"{t.shape} {p.shape}")
    lib = _load()
    args = [_ptr(a, ctypes.c_double) for a in (x, y, t, p)]
    args += [len(t), width, t_lo, t_hi]
    kept = lib.prepare_events(*args, None, None, None)
    pix = np.empty(kept, np.int32)
    ts = np.empty(kept, np.float32)
    pol = np.empty(kept, np.float32)
    lib.prepare_events(*args, _ptr(pix, _i32), _ptr(ts, ctypes.c_float),
                       _ptr(pol, ctypes.c_float))
    return pix, ts, pol


def prepare_events_numpy(x, y, t, p, width: int, t_lo: float, t_hi: float):
    """prepare_events in numpy: the plain version (the numpy branch of
    benerf_tpu/data/_native.py)."""
    x, y, t, p = (np.ascontiguousarray(a, np.float64) for a in (x, y, t, p))
    keep = (t >= t_lo) & (t <= t_hi)
    xs, ys, tt, pp = x[keep], y[keep], t[keep], p[keep]
    order = np.argsort(tt, kind="stable")
    span = (t_hi - t_lo) or 1.0
    pix = (ys[order].astype(np.int64) * width + xs[order]).astype(np.int32)
    return (pix, ((tt[order] - t_lo) / span).astype(np.float32),
            pp[order].astype(np.float32))
