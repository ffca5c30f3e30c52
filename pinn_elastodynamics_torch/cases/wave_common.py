"""Shared builders for the three elastic-wave cases: source circle, IC box,
collocation assembly — the structure the reference repeats per script.

Counterpart of ``pinn_elastodynamics_tpu/cases/wave_common.py`` (numpy;
the draws are the JAX package's, so the banks are equal to its banks).
"""

from __future__ import annotations

import numpy as np

from ..geometry import sampling as smp
from ..geometry.sources import radial_displacement


def source_bank_points(
    *, xc: float, yc: float, r: float, n_circle: int, tt: np.ndarray,
    amplitude_fn,
):
    """Source circle × time stations with radial displacement targets
    (ElasticWaveConfined/ElasticWave.py:952-968)."""
    circle = smp.circle_points(xc=xc, yc=yc, r=r, n=n_circle)
    pts = smp.cross_time(circle, tt)
    amp = amplitude_fn(pts[:, 2:3])
    uv = radial_displacement(pts[:, 0:2], amp, xc=xc, yc=yc, r=r)
    return pts, uv


def collocation_with_refinement(
    rng, *, lb, ub, n_bulk: int, refine_boxes, exclude=None
):
    """Bulk LHS + refinement boxes − source disk (the shared idiom,
    e.g. ElasticWaveConfined/ElasticWave.py:941-947)."""
    parts = [smp.lhs_box(lb, ub, n_bulk, rng)]
    for origin, extent, n in refine_boxes:
        parts.append(smp.edge_lhs(origin, extent, n, rng))
    pts = np.concatenate(parts, axis=0)
    if exclude is not None:
        xc, yc, r = exclude
        pts = smp.exclude_disk(pts, xc=xc, yc=yc, r=r, strict=True)
    return pts
