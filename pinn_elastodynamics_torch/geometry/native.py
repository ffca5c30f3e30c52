"""ctypes binding of the native (C++/OpenMP) point-generation library.

Counterpart of ``pinn_elastodynamics_tpu/geometry/native.py``.  The library
(``native/pointgen.cpp``: LHS sampling, disk filtering, distance targets,
time cross-products for 1M+ point banks) is built at first use with
``g++`` and the flags of ``native/Makefile`` into
``pinn_elastodynamics_torch/_build/`` under a name that carries a hash of
the source and the flags; ``native/`` itself is never written.  The numpy
implementations in ``sampling.py`` and ``distance.py`` define the
semantics.  When the library cannot be built or loaded, :func:`available`
is False and :func:`load_error` says why; the functions then raise.

The native LHS uses its own deterministic RNG (xoshiro256**), so values
differ from numpy's Generator stream; both satisfy the same Latin-hypercube
stratification contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "pointgen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
# native/Makefile:5-6.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fopenmp")
LD_FLAGS = ("-shared", "-fopenmp")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((CXX,) + CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"libpointgen_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of its exact source exists.  The
    compiler writes a private temporary name that ``os.replace`` moves into
    place, so concurrent builds never see a partial file."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *LD_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            # No compiler, no OpenMP runtime, a failed compile, ...
            _load_error = str(e)
            return None
        _configure(lib)
        _lib = lib
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    d = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.pg_lhs.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, d]
    lib.pg_lhs.restype = None
    lib.pg_scale_box.argtypes = [ctypes.c_int64, ctypes.c_int32, d, d, d]
    lib.pg_scale_box.restype = None
    lib.pg_disk_keep_mask.argtypes = [
        ctypes.c_int64, ctypes.c_int32, d, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int32, u8,
    ]
    lib.pg_disk_keep_mask.restype = ctypes.c_int64
    lib.pg_plate_hole_distance.argtypes = [ctypes.c_int64, d, d]
    lib.pg_plate_hole_distance.restype = None
    lib.pg_cross_time.argtypes = [
        ctypes.c_int64, ctypes.c_int32, d, ctypes.c_int64, d, d,
    ]
    lib.pg_cross_time.restype = None
    lib.pg_num_threads.argtypes = []
    lib.pg_num_threads.restype = ctypes.c_int32


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _load_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lhs(n_dims: int, n_samples: int, seed: int) -> np.ndarray:
    lib = _require()
    out = np.empty((n_samples, n_dims), dtype=np.float64)
    lib.pg_lhs(n_samples, n_dims, seed & 0xFFFFFFFFFFFFFFFF, _dp(out))
    return out


def lhs_box(
    lb: Sequence[float], ub: Sequence[float], n: int, seed: int
) -> np.ndarray:
    lib = _require()
    lb = np.ascontiguousarray(lb, dtype=np.float64)
    ub = np.ascontiguousarray(ub, dtype=np.float64)
    pts = lhs(len(lb), n, seed)
    lib.pg_scale_box(n, len(lb), _dp(lb), _dp(ub), _dp(pts))
    return pts


def exclude_disk(
    pts: np.ndarray, *, xc: float, yc: float, r: float, strict: bool = False
) -> np.ndarray:
    lib = _require()
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    keep = np.empty(pts.shape[0], dtype=np.uint8)
    lib.pg_disk_keep_mask(
        pts.shape[0], pts.shape[1], _dp(pts), xc, yc, r, int(strict),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return pts[keep.astype(bool)]


def plate_hole_distance(xyt: np.ndarray) -> np.ndarray:
    lib = _require()
    xyt = np.ascontiguousarray(xyt, dtype=np.float64)
    out = np.empty((xyt.shape[0], 5), dtype=np.float64)
    lib.pg_plate_hole_distance(xyt.shape[0], _dp(xyt), _dp(out))
    return out


def cross_time(xy: np.ndarray, t: np.ndarray) -> np.ndarray:
    lib = _require()
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    t = np.ascontiguousarray(t, dtype=np.float64)
    out = np.empty((xy.shape[0] * t.shape[0], xy.shape[1] + 1), np.float64)
    lib.pg_cross_time(
        xy.shape[0], xy.shape[1], _dp(xy), t.shape[0], _dp(t), _dp(out)
    )
    return out


def num_threads() -> int:
    lib = _load()
    return int(lib.pg_num_threads()) if lib else 0
