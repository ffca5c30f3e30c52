"""Leaves of parameter trees: nested dicts and lists of tensors.

The port keeps the JAX package's parameter layout (lists of ``{"W", "b"}``
dicts, nested in dicts for composites); these helpers take the place of
``jax.tree`` for it.  Dict keys are visited in sorted order, as JAX does.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise to ``tree`` and trees of the same shape,
    visiting the leaves in the order of :func:`tree_leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs in the order of :func:`tree_leaves`; a path reads
    as ``jax.tree_util.keystr`` writes it (``['uv'][0]['W']``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_leaves_with_path(t, f"{path}[{i}]")]
    return [(path, tree)]


def flat_numpy(tree) -> np.ndarray:
    """Every leaf of a tree of tensors, flattened and concatenated in the
    order of :func:`tree_leaves`, as one numpy array on the host."""
    return np.concatenate([t.detach().reshape(-1).cpu().numpy()
                           for t in tree_leaves(tree)])
