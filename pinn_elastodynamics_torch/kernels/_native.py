"""Build and bind the CUDA kernels of ``csrc/``.

The sources (``fused_jet.cu``: the forward jets; ``fused_jet_vjp.cu``: their
backward; both on the device functions of ``jet_wide.cuh``) have a plain C
interface.  Each is compiled by its own ``nvcc -c``
(``-split-compile``: its kernels in parallel), all started together, and one
more ``nvcc`` links the objects into one shared library, loaded with
``ctypes``; no PyTorch header is involved.  The library is built at first use into
``pinn_elastodynamics_torch/_build/`` under a name that carries a hash of
the sources, the shared header and the flags, so unchanged sources reuse it.
A build compiles to private temporary names and moves the library into
place with ``os.replace``, so concurrent builds never see a partial file and
no lock file is needed.  Nothing falls back: a failed build or load raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused_jet.cu", CSRC / "fused_jet_vjp.cu")
HEADERS = (CSRC / "jet_common.cuh", CSRC / "jet_wide.cuh")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# Compile step only: optimise a source's kernels in parallel on every core.
# The machine code is the same as a serial compile's; the build is shorter.
SPLIT_FLAGS = ("-split-compile=0",)
BUILD_TIMEOUT_S = 300
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # seed_f, seed_d, seed_tt, n, n_tangents, order, packed, dims, n_layers,
    # out, stream
    "fused_mlp_jet_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    # x, n, a, order, lb, ub, (packed, dims, n_layers) x 3, out, stream
    "fused_composite_jet_launch": [
        _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P],
    # seed_f, seed_d, seed_tt, cot, n, n_tangents, order, packed, dims,
    # n_layers, full_dx, max_blocks, partial, grad, dseed, workspace, stream
    "fused_mlp_jet_bwd_launch": [
        _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    # x, n, a, order, lb, ub, (packed, dims, n_layers) x 3, cot, max_blocks,
    # partial, grad, dx, workspace, stream
    "fused_composite_jet_bwd_launch": [
        _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I,
        _P, _P, _P, _P, _P],
}

# Size queries: name -> (argument types, result type).
QUERIES = {
    # n_tangents, order, dims, n_layers -> workspace floats per block, or -1
    "fused_mlp_jet_bwd_workspace": ([_I, _I, _P, _I], ctypes.c_longlong),
    # n_tangents, order, dims, n_layers -> the body launched (an index of
    # fused_jet_vjp.BODIES), or -1
    "fused_mlp_jet_bwd_body": ([_I, _I, _P, _I], ctypes.c_int),
    # a, order, (dims, n_layers) x 3 -> workspace floats per block, or -1
    "fused_composite_jet_bwd_workspace": (
        [_I, _I, _P, _I, _P, _I, _P, _I], ctypes.c_longlong),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for path in SOURCES + HEADERS:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + SPLIT_FLAGS).encode())
    return BUILD_DIR / f"libfused_jet_{digest.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (command, process); raise with the first failure's
    output after all have ended."""
    failed = None
    for cmd, proc in procs:
        try:
            out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            err = f"timed out after {BUILD_TIMEOUT_S} s\n{err}"
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                      f"{err}{out}")
    if failed:
        raise RuntimeError(failed)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile the library unless a build of its exact sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = lib.with_name(f"{lib.stem}.{tag}.tmp")
    objs = [lib.with_name(f"{lib.stem}.{src.stem}.{tag}.o") for src in SOURCES]
    nvcc = _nvcc()
    try:
        _run([_start([nvcc, *NVCC_FLAGS, *SPLIT_FLAGS, "-c", "-o", str(obj),
                      str(src)])
              for src, obj in zip(SOURCES, objs)])
        _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)])])
        os.replace(tmp, lib)
    finally:
        for path in (tmp, *objs):
            path.unlink(missing_ok=True)
    return lib


def bind(path) -> ctypes.CDLL:
    """Load a library of these sources and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.fused_jet_error_string.argtypes = [ctypes.c_int]
    lib.fused_jet_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library; the first use builds it."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().fused_jet_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
