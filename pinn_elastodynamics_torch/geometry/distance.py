"""Analytic space-time distance targets for the hard-BC distance network.

A copy of ``pinn_elastodynamics_tpu/geometry/distance.py`` (numpy).

Vectorized numpy versions of the reference's per-point ``GenDist`` loops:
  quarter plate — PlateHoleQuarter/train/train.py:643-656
  confined wave — ElasticWaveConfined/ElasticWave.py:510-526

Each per-channel field is ``min(t, geometric distances to the constrained
boundaries)`` so the regressed distance net vanishes exactly where the
corresponding output channel is constrained (and at t=0 for ICs).
"""

from __future__ import annotations

import numpy as np


def plate_hole_distance(xyt: np.ndarray) -> np.ndarray:
    """Distance targets for the quarter-plate case (train.py:643-656).

    Channels [d_u, d_v, d_s11, d_s22, d_s12] on the domain [0, .5]^2:
      u  constrained on the left edge (x=0) and at t=0
      v  constrained on the lower edge (y=0) and at t=0
      s11 prescribed on the right edge (x=.5); s22 free on top (y=.5);
      s12 zero on all four edges.
    """
    x, y, t = xyt[:, 0], xyt[:, 1], xyt[:, 2]
    d_u = np.minimum(t, x)
    d_v = np.minimum(t, y)
    d_s11 = np.minimum(t, 0.5 - x)
    d_s22 = np.minimum(t, 0.5 - y)
    d_s12 = np.minimum.reduce([t, y, 0.5 - y, x, 0.5 - x])
    return np.stack([d_u, d_v, d_s11, d_s22, d_s12], axis=1)


def confined_wave_distance(xyt: np.ndarray) -> np.ndarray:
    """Distance targets for the confined-wave case
    (ElasticWaveConfined/ElasticWave.py:510-526): u and v vanish on all four
    edges of [-15, 15]^2, on the r=2 source circle, and at t=0; scaled by
    1/10.  Stress channels are constant 1.0 (unused by that case's loss).
    """
    x, y, t = xyt[:, 0], xyt[:, 1], xyt[:, 2]
    geo = np.minimum.reduce(
        [
            t,
            np.sqrt(x**2 + y**2) - 2.0,
            15.0 - x,
            x + 15.0,
            15.0 - y,
            y + 15.0,
        ]
    ) / 10.0
    ones = np.ones_like(geo)
    return np.stack([geo, geo, ones, ones, ones], axis=1)
