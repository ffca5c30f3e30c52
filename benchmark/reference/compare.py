"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes, each a relative size.

Gaps of vectors are taken leaf by leaf (a leaf is one weight matrix or
bias vector) and the worst leaf counts, over the reference's norm of that
leaf or of the median leaf, whichever is larger, since some leaves'
gradients are all but zero: ``leaf_gap`` takes the gap between the
program's norm and the reference's, ``leaf_vec_gap`` the norm of their
difference, which also sees a leaf turned, transposed or of the wrong sign.
``vec_gap`` takes the norm of the difference of whole vectors, which the
largest leaves steady where the worst leaf swings from seed to seed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# A leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone and is left out of the parameters' change.
NEGLIGIBLE_GRAD = 1e-3


def leaf_norms(vec: np.ndarray, slices: Sequence[slice]) -> np.ndarray:
    return np.array([float(np.linalg.norm(vec[s])) for s in slices])


def leaf_gap(prog: np.ndarray, ref: np.ndarray, slices: Sequence[slice],
             keep: Optional[np.ndarray] = None) -> float:
    p, r = leaf_norms(prog, slices), leaf_norms(ref, slices)
    if keep is not None:
        p, r = p[keep], r[keep]
    floor = float(np.median(r))
    return float(np.max(np.abs(p - r) / np.maximum(r, floor)))


def leaf_vec_gap(prog: np.ndarray, ref: np.ndarray, slices: Sequence[slice],
                 keep: Optional[np.ndarray] = None) -> float:
    d, r = leaf_norms(prog - ref, slices), leaf_norms(ref, slices)
    if keep is not None:
        d, r = d[keep], r[keep]
    floor = float(np.median(r))
    return float(np.max(d / np.maximum(r, floor)))


def vec_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The norm of the difference of two whole vectors over the
    reference's norm."""
    return float(np.linalg.norm(prog - ref) / np.linalg.norm(ref))


def moving_leaves(grad_ref: np.ndarray, slices: Sequence[slice]) -> np.ndarray:
    """The leaves whose reference gradient is not negligible."""
    g = leaf_norms(grad_ref, slices)
    return g >= NEGLIGIBLE_GRAD * float(np.median(g))


def relative_gap(prog: float, ref: float) -> float:
    if not np.isfinite(prog):
        return float("inf")
    return abs(prog - ref) / abs(ref)


def field_gap(prog: dict, ref: dict, scale: dict) -> float:
    """The widest gap of any served field at any point, over that field's
    largest magnitude in the reference's answers; a missing field, or an
    answer of another length, reads infinite."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or np.shape(p) != np.shape(r):
            return float("inf")
        d = np.abs(np.asarray(p, np.float64) - r)
        if not np.all(np.isfinite(d)):
            return float("inf")
        if d.size:
            worst = max(worst, float(d.max()) / scale[k])
    return worst
