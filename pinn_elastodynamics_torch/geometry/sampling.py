"""Collocation / boundary / IC point samplers (host-side, numpy).

A copy of ``pinn_elastodynamics_tpu/geometry/sampling.py``, which the port
cannot import (that package imports JAX).  It re-implements the reference's data layer — pyDOE ``lhs`` boxes, refinement
boxes, hole/cavity exclusion, edge and circle point factories, cartesian grids
(PlateHoleQuarter/train/train.py:614-641,857-869,899-929;
ElasticWaveInfinite/ElasticWave.py:378-389,612-632) — without
the pyDOE dependency.  All samplers return float64 numpy arrays; banks are
cast/padded to the device dtype downstream (see ``banks.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def lhs(n_dims: int, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """Latin hypercube sample on [0, 1]^d (drop-in for pyDOE's ``lhs``)."""
    u = rng.uniform(size=(n_samples, n_dims))
    out = np.empty_like(u)
    for j in range(n_dims):
        perm = rng.permutation(n_samples)
        out[:, j] = (perm + u[:, j]) / n_samples
    return out


def lhs_box(
    lb: Sequence[float],
    ub: Sequence[float],
    n: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """LHS over an axis-aligned box — the reference's ``lb + (ub-lb)*lhs`` idiom."""
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    return lb + (ub - lb) * lhs(len(lb), n, rng)


def exclude_disk(
    pts: np.ndarray, *, xc: float, yc: float, r: float, strict: bool = False
) -> np.ndarray:
    """Drop points inside a disk (DelHolePT train.py:857-860 / DelSrcPT).

    ``strict=True`` keeps only dst > r (reference DelHolePT/DelSrcPT); False
    keeps dst >= r (reference grid filters, train.py:986).
    """
    dst = np.sqrt((pts[:, 0] - xc) ** 2 + (pts[:, 1] - yc) ** 2)
    keep = dst > r if strict else dst >= r
    return pts[keep]


def circle_points(
    *, xc: float, yc: float, r: float, n: int,
    theta0: float = 0.0, theta1: float = 2.0 * np.pi,
) -> np.ndarray:
    """Points on a circular arc; quarter arc for the hole (train.py:862-869)."""
    theta = np.linspace(theta0, theta1, n)
    x = r * np.cos(theta) + xc
    y = r * np.sin(theta) + yc
    return np.stack([x, y], axis=1)


def cross_time(xy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Cartesian product of spatial points with time stations.

    Matches the reference meshgrid idiom (train.py:908-916): output rows are
    ordered time-major ((t0, all xy), (t1, all xy), ...).
    """
    n_xy, n_t = xy.shape[0], t.shape[0]
    xy_rep = np.tile(xy, (n_t, 1))
    t_rep = np.repeat(np.asarray(t, dtype=np.float64), n_xy)[:, None]
    return np.concatenate([xy_rep, t_rep], axis=1)


def cart_grid_2d(
    xmin, xmax, ymin, ymax, num: int
) -> np.ndarray:
    """Uniform 2D grid, flattened to (num*num, 2); CartGrid analog."""
    x = np.linspace(xmin, xmax, num)
    y = np.linspace(ymin, ymax, num)
    xx, yy = np.meshgrid(x, y)
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


def grid_disk_complement(
    xmin, xmax, ymin, ymax, num: int, *, xc=0.0, yc=0.0, r=0.0
) -> np.ndarray:
    """Uniform grid minus a disk — the reference's eval grids (train.py:980-989)."""
    pts = cart_grid_2d(xmin, xmax, ymin, ymax, num)
    if r > 0:
        pts = exclude_disk(pts, xc=xc, yc=yc, r=r, strict=False)
    return pts


def dist_grid_with_surface(
    *, xmin, xmax, ymin, ymax, tmin, tmax, xc, yc, r,
    num_surf_pt: int, num: int, num_t: int,
    arc: str = "quarter",
) -> np.ndarray:
    """Spacetime grid for distance-net regression targets (GenDistPt,
    train.py:614-641): uniform spatial grid minus the hole, plus refinement
    points on the hole surface, crossed with uniform time stations.
    """
    xy = cart_grid_2d(xmin, xmax, ymin, ymax, num)
    xy = exclude_disk(xy, xc=xc, yc=yc, r=r, strict=False)
    theta1 = np.pi / 2.0 if arc == "quarter" else 2.0 * np.pi
    surf = circle_points(xc=xc, yc=yc, r=r, n=num_surf_pt, theta1=theta1)
    xy = np.concatenate([xy, surf], axis=0)
    t = np.linspace(tmin, tmax, num_t)
    return cross_time(xy, t)


def edge_lhs(
    origin: Sequence[float],
    extent: Sequence[float],
    n: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """LHS on an axis-aligned (degenerate) box — the reference's edge-point
    idiom ``origin + extent * lhs(3, n)`` (train.py:918-921)."""
    origin = np.asarray(origin, dtype=np.float64)
    extent = np.asarray(extent, dtype=np.float64)
    return origin + extent * lhs(len(origin), n, rng)


def subsample(pts: np.ndarray, every: int) -> np.ndarray:
    """Stride-subsample boundary points folded into the collocation set
    (train.py:929)."""
    return pts[::every]


def shuffled(rng: np.random.Generator, *arrays: np.ndarray):
    """Row-shuffle each array independently (rows are i.i.d. samples).

    The reference's ``shuffle`` (ElasticWaveInfinite/ElasticWave.py:627-632)
    does the same in place; here paired columns within one array stay paired,
    which is what makes the independent per-array shuffle safe.
    """
    return tuple(a[rng.permutation(a.shape[0])] for a in arrays)
