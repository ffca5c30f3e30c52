"""Surface traction t = sigma · n (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/ops/traction.py``, with the
reference's circular-hole normal n = (-x/r, -y/r) (PlateHoleQuarter/train/
train.py:441-461).
"""

from __future__ import annotations

import torch

from ..models.fields import FieldSpec


def traction_2d(fields: torch.Tensor, spec: FieldSpec, nx, ny):
    """tx = s11·nx + s12·ny, ty = s12·nx + s22·ny."""
    s11 = fields[:, spec.index("s11")]
    s22 = fields[:, spec.index("s22")]
    s12 = fields[:, spec.index("s12")]
    return s11 * nx + s12 * ny, s12 * nx + s22 * ny


def circle_normals(x, y, *, xc=0.0, yc=0.0, r=0.1):
    """Hole normal n = (-(x-xc)/r, -(y-yc)/r)."""
    return -(x - xc) / r, -(y - yc) / r


def traction_3d(fields: torch.Tensor, spec: FieldSpec, nx, ny, nz):
    s = {n: fields[:, spec.index(n)] for n in
         ("s11", "s22", "s33", "s12", "s13", "s23")}
    tx = s["s11"] * nx + s["s12"] * ny + s["s13"] * nz
    ty = s["s12"] * nx + s["s22"] * ny + s["s23"] * nz
    tz = s["s13"] * nx + s["s23"] * ny + s["s33"] * nz
    return tx, ty, tz
