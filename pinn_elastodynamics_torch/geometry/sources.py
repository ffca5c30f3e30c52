"""Boundary / source load time-signatures used by the reference cases.

A copy of ``pinn_elastodynamics_tpu/geometry/sources.py`` (numpy).

  cyclic tension  — PlateHoleQuarter/train/train.py:924-925
  gaussian pulse  — ElasticWaveConfined/ElasticWave.py:965
  ricker wavelet  — ElasticWaveInfinite/ElasticWave.py:703
"""

from __future__ import annotations

import numpy as np


def cyclic_tension(t, *, period: float = 5.0, amplitude: float = 0.5):
    """s11(t) = A·sin(2πt/period + 3π/2) + A — zero at t=0, peaks at 2A."""
    return amplitude * np.sin((2.0 * np.pi / period) * t + 1.5 * np.pi) + amplitude


def gaussian_pulse(t, *, t0: float = 2.0, width: float = 0.5, amplitude: float = 0.5):
    """A·exp(-((t-t0)/width)²) — confined-wave source amplitude."""
    return amplitude * np.exp(-(((t - t0) / width) ** 2))


def ricker_wavelet(t, *, ts: float = 3.0, tsh: float = 3.0, amplitude: float = 1.0):
    """A·(2π²(t-ts)²/tsh² - 1)·exp(-π²(t-ts)²/tsh²) — infinite/semi-infinite
    wave source amplitude (a Ricker-style wavelet, sign-flipped)."""
    q = np.pi**2 * (t - ts) ** 2 / tsh**2
    return amplitude * (2.0 * q - 1.0) * np.exp(-q)


def radial_displacement(xy: np.ndarray, amplitude, *, xc=0.0, yc=0.0, r=2.0):
    """Prescribed radial displacement on a source circle:
    (u, v) = amp · ((x-xc)/r, (y-yc)/r) (ElasticWaveConfined:966-967)."""
    u = amplitude * (xy[:, 0:1] - xc) / r
    v = amplitude * (xy[:, 1:2] - yc) / r
    return np.concatenate([u, v], axis=1)
