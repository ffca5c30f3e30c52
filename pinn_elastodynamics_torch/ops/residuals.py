"""Elastodynamics PDE residual assembly from field jets (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/ops/residuals.py``: momentum
balance, the constitutive law and, for the first-order system, the
velocity-definition residuals (the reference's PlateHoleQuarter/train/
train.py:404-439 and ElasticWaveConfined/ElasticWave.py:304-348), read off
one :class:`~..ops.jet.Jet`.  All residuals are (N,) tensors keyed by name.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.fields import FIRST_ORDER, SECOND_ORDER, FieldSpec
from .elasticity import (
    ISOTROPIC_3D,
    PLANE_STRAIN,
    PLANE_STRESS,
    Material,
    isotropic_3d_stress,
    plane_strain_stress,
    plane_stress_stress,
)

# Input-coordinate indices.
X, Y, T2D = 0, 1, 2
Z, T3D = 2, 3


def strains_2d(jet, spec: FieldSpec):
    """Engineering strains e11, e22, e12 = (u_y + v_x)."""
    iu, iv = spec.index("u"), spec.index("v")
    e11 = jet.d[X][:, iu]
    e22 = jet.d[Y][:, iv]
    e12 = jet.d[Y][:, iu] + jet.d[X][:, iv]
    return e11, e22, e12


def strains_3d(jet, spec: FieldSpec):
    iu, iv, iw = spec.index("u"), spec.index("v"), spec.index("w")
    e11 = jet.d[X][:, iu]
    e22 = jet.d[Y][:, iv]
    e33 = jet.d[Z][:, iw]
    e12 = jet.d[Y][:, iu] + jet.d[X][:, iv]
    e13 = jet.d[Z][:, iu] + jet.d[X][:, iw]
    e23 = jet.d[Z][:, iv] + jet.d[Y][:, iw]
    return e11, e22, e33, e12, e13, e23


def residuals_2d(jet, spec: FieldSpec, mat: Material,
                 plane: str) -> Dict[str, torch.Tensor]:
    """All 2D PDE residuals from one jet.

    Returns f_u, f_v (momentum), f_s11/f_s22/f_s12 (constitutive), and for
    the first-order formulation also f_ut, f_vt (velocity definition).
    """
    ch = spec.index
    s11 = jet.f[:, ch("s11")]
    s22 = jet.f[:, ch("s22")]
    s12 = jet.f[:, ch("s12")]

    e11, e22, e12 = strains_2d(jet, spec)
    if plane == PLANE_STRESS:
        sp11, sp22, sp12 = plane_stress_stress(mat, e11, e22, e12)
    elif plane == PLANE_STRAIN:
        sp11, sp22, sp12 = plane_strain_stress(mat, e11, e22, e12)
    else:
        raise ValueError(f"unknown plane mode {plane!r}")

    out = {
        "f_s11": s11 - sp11,
        "f_s22": s22 - sp22,
        "f_s12": s12 - sp12,
    }

    s11_x = jet.d[X][:, ch("s11")]
    s12_y = jet.d[Y][:, ch("s12")]
    s22_y = jet.d[Y][:, ch("s22")]
    s12_x = jet.d[X][:, ch("s12")]

    if spec.formulation == FIRST_ORDER:
        # Velocity is a network output; u_tt := d(ut)/dt.
        iu, iv = ch("u"), ch("v")
        iut, ivt = ch("ut"), ch("vt")
        out["f_ut"] = jet.d[T2D][:, iu] - jet.f[:, iut]
        out["f_vt"] = jet.d[T2D][:, iv] - jet.f[:, ivt]
        u_tt = jet.d[T2D][:, iut]
        v_tt = jet.d[T2D][:, ivt]
    elif spec.formulation == SECOND_ORDER:
        # u_tt from the jet's second-order time stream.
        u_tt = jet.dtt[:, ch("u")]
        v_tt = jet.dtt[:, ch("v")]
    else:
        raise ValueError(f"unknown formulation {spec.formulation!r}")

    out["f_u"] = s11_x + s12_y - mat.rho * u_tt
    out["f_v"] = s22_y + s12_x - mat.rho * v_tt
    return out


def residuals_3d(jet, spec: FieldSpec, mat: Material,
                 plane: str = ISOTROPIC_3D) -> Dict[str, torch.Tensor]:
    """3D elastodynamics residuals."""
    del plane
    ch = spec.index
    strains = strains_3d(jet, spec)
    sp = isotropic_3d_stress(mat, *strains)
    names = ("s11", "s22", "s33", "s12", "s13", "s23")
    out = {f"f_{n}": jet.f[:, ch(n)] - sp_i for n, sp_i in zip(names, sp)}

    def dstress(n, axis):
        return jet.d[axis][:, ch(n)]

    if spec.formulation == FIRST_ORDER:
        accel = {}
        for disp, vel in (("u", "ut"), ("v", "vt"), ("w", "wt")):
            out[f"f_{vel}"] = jet.d[T3D][:, ch(disp)] - jet.f[:, ch(vel)]
            accel[disp] = jet.d[T3D][:, ch(vel)]
    else:
        accel = {n: jet.dtt[:, ch(n)] for n in ("u", "v", "w")}

    out["f_u"] = (dstress("s11", X) + dstress("s12", Y) + dstress("s13", Z)
                  - mat.rho * accel["u"])
    out["f_v"] = (dstress("s12", X) + dstress("s22", Y) + dstress("s23", Z)
                  - mat.rho * accel["v"])
    out["f_w"] = (dstress("s13", X) + dstress("s23", Y) + dstress("s33", Z)
                  - mat.rho * accel["w"])
    return out


def residuals(jet, spec: FieldSpec, mat: Material, plane: str):
    if spec.ndim == 2:
        return residuals_2d(jet, spec, mat, plane)
    return residuals_3d(jet, spec, mat, plane)


# Residual-name groups of the reference's loss weighting: momentum (+
# velocity-definition) residuals are weighted together as "f_uv",
# constitutive residuals as "f_s".
def momentum_group(spec: FieldSpec):
    names = ["f_u", "f_v"] + (["f_w"] if spec.ndim == 3 else [])
    if spec.formulation == FIRST_ORDER:
        names += ["f_ut", "f_vt"] + (["f_wt"] if spec.ndim == 3 else [])
    return tuple(names)


def stress_group(spec: FieldSpec):
    if spec.ndim == 2:
        return ("f_s11", "f_s22", "f_s12")
    return ("f_s11", "f_s22", "f_s33", "f_s12", "f_s13", "f_s23")
