"""Point samplers of the benchmark: a frozen copy, on the host in numpy.

These are the reference project's sampling idioms (pyDOE ``lhs`` boxes,
hole and source-disk exclusion, arcs and edges crossed with time stations;
Rao, Sun and Liu, PlateHoleQuarter/train/train.py:857-929 and
ElasticWaveConfined/ElasticWave.py:926-968), copied so that the banks the
benchmark times do not move when the program's own samplers change.  Every
draw comes from one ``numpy.random.Generator`` seeded by the run's
``--seed``; the program and the reference are handed the same arrays.
"""

from __future__ import annotations

import numpy as np


def lhs(n_dims: int, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """Latin hypercube sample on [0, 1]^d."""
    u = rng.uniform(size=(n_samples, n_dims))
    out = np.empty_like(u)
    for j in range(n_dims):
        out[:, j] = (rng.permutation(n_samples) + u[:, j]) / n_samples
    return out


def lhs_box(lb, ub, n: int, rng: np.random.Generator) -> np.ndarray:
    """LHS over an axis-aligned box: ``lb + (ub - lb)·lhs``."""
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    return lb + (ub - lb) * lhs(len(lb), n, rng)


def edge_lhs(origin, extent, n: int, rng: np.random.Generator) -> np.ndarray:
    """LHS on a (degenerate) box: ``origin + extent·lhs``."""
    origin = np.asarray(origin, dtype=np.float64)
    extent = np.asarray(extent, dtype=np.float64)
    return origin + extent * lhs(len(origin), n, rng)


def exclude_disk(pts: np.ndarray, *, xc: float, yc: float, r: float) -> np.ndarray:
    """Rows strictly outside the disk."""
    return pts[np.sqrt((pts[:, 0] - xc) ** 2 + (pts[:, 1] - yc) ** 2) > r]


def circle_points(*, xc: float, yc: float, r: float, n: int,
                  theta1: float = 2.0 * np.pi) -> np.ndarray:
    """``n`` points on the arc from angle 0 to ``theta1``, ends included."""
    theta = np.linspace(0.0, theta1, n)
    return np.stack([r * np.cos(theta) + xc, r * np.sin(theta) + yc], axis=1)


def cross_time(xy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Every spatial point at every time station, time-major."""
    n_xy, n_t = xy.shape[0], t.shape[0]
    return np.concatenate(
        [np.tile(xy, (n_t, 1)),
         np.repeat(np.asarray(t, dtype=np.float64), n_xy)[:, None]], axis=1)


def gaussian_pulse(t):
    """The confined wave's source amplitude 0.5·exp(-((t - 2)/0.5)²)."""
    return 0.5 * np.exp(-(((t - 2.0) / 0.5) ** 2))


def radial_displacement(xy: np.ndarray, amplitude, *, xc: float, yc: float,
                        r: float) -> np.ndarray:
    """(u, v) = amplitude·((x - xc)/r, (y - yc)/r) on a source circle."""
    return np.concatenate([amplitude * (xy[:, 0:1] - xc) / r,
                           amplitude * (xy[:, 1:2] - yc) / r], axis=1)


def points_outside_disk(rng: np.random.Generator, n: int, lo: float,
                        hi: float, *, r: float) -> np.ndarray:
    """``n`` uniform points of the square [lo, hi]² outside the disk of
    radius ``r`` at the origin (rejection sampling)."""
    out = np.empty((0, 2))
    while out.shape[0] < n:
        cand = rng.uniform(lo, hi, size=(2 * n, 2))
        out = np.concatenate([out, exclude_disk(cand, xc=0.0, yc=0.0, r=r)])
    return out[:n]
