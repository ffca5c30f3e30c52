"""Build and bind the CUDA kernels of ``csrc/fused_jet.cu``.

The source has a plain C interface, so it is compiled by one ``nvcc`` call
into a shared library and loaded with ``ctypes``; no PyTorch header is
involved, which keeps the build to seconds.  The library is built at first
use into ``pinn_elastodynamics_torch/_build/`` under a name that carries a
hash of the source and flags, so an unchanged source reuses it.  A build
compiles to a private temporary name and is moved into place with
``os.replace``, so concurrent builds never see a partial file and no lock
file is needed.  Nothing falls back: a failed build or load raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_jet.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 300
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # seed_f, seed_d, seed_tt, n, n_tangents, order, packed, dims, n_layers,
    # out, stream
    "fused_mlp_jet_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    # x, n, a, order, lb, ub, (packed, dims, n_layers) x 3, out, stream
    "fused_composite_jet_launch": [
        _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        f"nvcc not found on PATH or at {NVCC_DEFAULT}: the CUDA toolkit is "
        "needed to build the fused-jet kernels")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_jet_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this exact source exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fused_jet_error_string.argtypes = [ctypes.c_int]
            lib.fused_jet_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().fused_jet_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
