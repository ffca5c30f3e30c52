"""Checkpoint I/O and parameter conversion (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/train/checkpoint.py``:

* **native** checkpoints are one pickle of a numpy tree (parameters under
  ``"params"``, plus optimizer state and counters);
  :func:`save_checkpoint` writes one atomically, :func:`load_checkpoint`
  returns that tree as numpy and :func:`tensors_from_checkpoint` puts it
  back on a device (an L-BFGS carry or Adam state included);
* **reference** pickles hold ``[weights_list, biases_list]`` with biases
  shaped (1, out); :func:`load_reference_pickle` returns MLP parameters and
  :func:`save_reference_pickle` writes them.

:func:`params_from_jax` turns a JAX parameter tree held as numpy arrays
(nested dicts and lists of ``{"W", "b"}``, ``{"B", "mlp"}`` for Fourier
nets) into the port's tensors on a device.  Unpickling runs code from the
file, so load only checkpoints this project wrote.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from ..models.mlp import Params, mlp_layers


def save_checkpoint(path: str, tree) -> None:
    """Atomically pickle a tree (params, optimizer state, counters), its
    tensors as numpy arrays, so the JAX package reads it too."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    host = conv(tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(host, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, dtype=None):
    """Unpickle a native checkpoint as a numpy tree.

    Float leaves are cast to ``dtype`` when given; integer and bool leaves
    (step counters, flags) keep theirs.
    """
    with open(path, "rb") as f:
        host = pickle.load(f)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, np.ndarray) and x.dtype.kind == "f" and dtype is not None:
            return x.astype(dtype)
        return x

    return conv(host)


def tensors_from_checkpoint(tree, *, device="cuda", dtype=None):
    """A loaded numpy tree (parameters, optimizer state or carry) → tensors
    on ``device``.

    Float arrays become ``dtype`` when given; integer and bool arrays keep
    theirs, as :func:`load_checkpoint` keeps them.  Other leaves (phase
    names, Python counters) are returned as they are.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, np.ndarray):
            t = torch.tensor(x, device=dev)
            if x.dtype.kind == "f" and dtype is not None:
                t = t.to(dtype)
            return t
        return x

    return conv(tree)


def params_from_jax(tree, *, device="cuda", dtype=torch.float32):
    """Numpy parameter tree (JAX layout) → the same tree of tensors."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        arr = np.asarray(x)
        if arr.dtype.kind != "f":
            raise TypeError(f"parameter leaf of dtype {arr.dtype} is not float")
        return torch.tensor(arr, dtype=dtype, device=dev)

    return conv(tree)


def load_reference_pickle(path: str, *, device="cuda",
                          dtype=torch.float32) -> Params:
    """Load a reference ``[weights, biases]`` pickle as MLP parameters."""
    with open(path, "rb") as f:
        weights, biases = pickle.load(f)
    if len(weights) != len(biases):
        raise ValueError(
            f"malformed reference pickle: {len(weights)} weights vs "
            f"{len(biases)} biases"
        )
    layers = []
    for w, b in zip(weights, biases):
        w = np.asarray(w)
        b = np.asarray(b).reshape(-1)
        if w.shape[1] != b.shape[0]:
            raise ValueError(f"layer shape mismatch: W {w.shape} vs b {b.shape}")
        layers.append({"W": w, "b": b})
    return params_from_jax(layers, device=device, dtype=dtype)


def save_reference_pickle(path: str, params: Params) -> None:
    """Write MLP parameters in the reference's pickle layout (b as (1, out))."""
    weights = [layer["W"].detach().cpu().numpy() for layer in params]
    biases = [layer["b"].detach().cpu().numpy()[None, :] for layer in params]
    with open(path, "wb") as f:
        pickle.dump([weights, biases], f)


def assert_layers_match(params: Params, layers) -> None:
    """The reference's load-time layer assert (train.py:299)."""
    dims = mlp_layers(params)
    if list(layers) != dims:
        raise AssertionError(
            f"checkpoint layers {dims} != expected {list(layers)}")
