"""Dotted-path access into nested dict parameter trees.

Counterpart of ``pinn_elastodynamics_tpu/utils/treepath.py``.
``Phase.trainable`` may be a dotted path ("uv.mlp" trains a Fourier net's
MLP tail while its frequency matrix ``uv.B`` stays frozen).
"""

from __future__ import annotations


def path_get(tree, path: str):
    """Return the subtree at a dotted ``path`` ("uv.mlp") of nested dicts."""
    for p in path.split("."):
        tree = tree[p]
    return tree


def path_set(tree, path: str, value):
    """Return a copy of ``tree`` with the subtree at ``path`` replaced.

    Only the dicts along the path are copied; every other branch is shared
    with the input.
    """
    parts = path.split(".")

    def rec(t, ps):
        if not ps:
            return value
        out = dict(t)
        out[ps[0]] = rec(t[ps[0]], ps[1:])
        return out

    return rec(tree, parts)
