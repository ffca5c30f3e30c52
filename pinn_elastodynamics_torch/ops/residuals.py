"""Strain assembly from field jets (PyTorch).

The part of ``pinn_elastodynamics_tpu/ops/residuals.py`` that field
rendering needs: the input-coordinate indices and the 2D engineering
strains.
"""

from __future__ import annotations

# Input-coordinate indices.
X, Y, T2D = 0, 1, 2
Z, T3D = 2, 3


def strains_2d(jet, spec):
    """Engineering strains e11, e22, e12 = (u_y + v_x)."""
    iu, iv = spec.index("u"), spec.index("v")
    e11 = jet.d[X][:, iu]
    e22 = jet.d[Y][:, iv]
    e12 = jet.d[Y][:, iu] + jet.d[X][:, iv]
    return e11, e22, e12
