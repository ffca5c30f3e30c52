"""Numerical-debugging helpers.

Counterpart of ``pinn_elastodynamics_tpu/utils/debug.py``.  The reference's
only guard against numerical failure is rerunning by hand (SURVEY.md §5).
Here: a NaN-hunting scope for development (autograd's anomaly detection in
place of ``jax_debug_nans``), finite-ness assertions for checkpoints and
steps, and a tree diff for reproducibility checks.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

from .tree import tree_leaves, tree_leaves_with_path


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@contextlib.contextmanager
def nan_debugging(enable: bool = True) -> Iterator[None]:
    """Turn on ``torch.autograd`` anomaly detection within a scope: a
    backward that produces NaN raises and names the forward op that
    created it."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True):
        yield


def assert_finite(tree, name: str = "pytree") -> None:
    """Raise with the offending leaf path (``['uv'][0]['W']``, in
    :func:`~.tree.tree_leaves` order) if any value is non-finite."""
    for path, leaf in tree_leaves_with_path(tree):
        t = _tensor(leaf)
        if not (t.is_floating_point() or t.is_complex()):
            continue
        bad = ~torch.isfinite(t)
        if bool(bad.any()):
            raise FloatingPointError(
                f"{name}{path}: {int(bad.sum())} non-finite values "
                f"(shape {tuple(t.shape)})"
            )


def tree_max_abs_diff(a, b) -> float:
    """Max |a - b| across two trees of the same structure (reproducibility
    and parity checks)."""
    diffs = [float(torch.max(torch.abs(_tensor(x) - _tensor(y))))
             for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)]
    return float(max(diffs, default=0.0))
