"""Isotropic linear-elastic constitutive relations (2D plane stress/strain, 3D).

Counterpart of ``pinn_elastodynamics_tpu/ops/elasticity.py``, with the
reference's coefficients (PlateHoleQuarter/train/train.py:415-418 for plane
stress, ElasticWaveConfined/ElasticWave.py:320-324 for plane strain).  The
fields of :class:`Material` may be floats or tensors.
"""

from __future__ import annotations

import dataclasses

PLANE_STRESS = "plane_stress"
PLANE_STRAIN = "plane_strain"
ISOTROPIC_3D = "isotropic_3d"


@dataclasses.dataclass
class Material:
    """Isotropic material: Young's modulus, Poisson ratio, density."""

    E: object
    mu: object
    rho: object

    @property
    def lame_lambda(self):
        return self.E * self.mu / ((1.0 + self.mu) * (1.0 - 2.0 * self.mu))

    @property
    def shear_modulus(self):
        return self.E / (2.0 * (1.0 + self.mu))


def plane_stress_stress(mat: Material, e11, e22, e12):
    """sigma from engineering strains under plane stress."""
    c = mat.E / (1.0 - mat.mu * mat.mu)
    s11 = c * e11 + c * mat.mu * e22
    s22 = c * mat.mu * e11 + c * e22
    s12 = mat.shear_modulus * e12  # e12 is engineering shear (u_y + v_x)
    return s11, s22, s12


def plane_strain_stress(mat: Material, e11, e22, e12):
    """sigma from engineering strains under plane strain."""
    coef = mat.E / ((1.0 + mat.mu) * (1.0 - 2.0 * mat.mu))
    s11 = coef * (1.0 - mat.mu) * e11 + coef * mat.mu * e22
    s22 = coef * mat.mu * e11 + coef * (1.0 - mat.mu) * e22
    s12 = mat.shear_modulus * e12
    return s11, s22, s12


def isotropic_3d_stress(mat: Material, e11, e22, e33, e12, e13, e23):
    """sigma from engineering strains (e_ij = u_i,j + u_j,i for i≠j), 3D."""
    lam = mat.lame_lambda
    g = mat.shear_modulus
    tr = e11 + e22 + e33
    s11 = lam * tr + 2.0 * g * e11
    s22 = lam * tr + 2.0 * g * e22
    s33 = lam * tr + 2.0 * g * e33
    s12 = g * e12
    s13 = g * e13
    s23 = g * e23
    return s11, s22, s33, s12, s13, s23
