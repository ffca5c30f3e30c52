"""Quarter plate with a circular hole under cyclic tension — the flagship case.

Counterpart of the model side of ``pinn_elastodynamics_tpu/cases/
plate_hole.py``: the geometry constants, the closed-form distance and
particular factors, and ``build_model``.  Plane stress, second-order
(5-output) formulation; geometry [0, 0.5]² minus an r=0.1 quarter-hole at
the origin, T = 10.
"""

from __future__ import annotations

import math

import torch

from ..models.analytic_bc import AnalyticCompositeFieldModel
from ..models.fields import (
    CompositeFieldModel,
    FieldSpec,
    MLPFieldModel,
    SECOND_ORDER,
)
from ..models.fourier import FourierMLPFieldModel

HOLE_R = 0.1
LB = (0.0, 0.0, 0.0)
UB = (0.5, 0.5, 10.0)


def analytic_dist(p):
    """Closed-form smooth distance factors [d_u, d_v, d_s11, d_s22, d_s12].

    Each constraint arm is L·tanh(z/L) (slope 1 at the constraint); the u/v
    time factor is tanh²(t) so that ∂D/∂t(t=0) = 0 (zero initial velocity
    holds by construction), the stresses' is tanh(t).
    """
    x, y, t = p[0], p[1], p[2]
    L = 0.25
    s = lambda z: L * torch.tanh(z / L)
    tv = torch.tanh(t) ** 2      # value+velocity IC factor (u, v)
    ts = torch.tanh(t)           # value-only IC factor (stresses)
    d_u = tv * s(x)
    d_v = tv * s(y)
    d_s11 = ts * s(0.5 - x)
    d_s22 = ts * s(0.5 - y)
    s_q = L * math.tanh(0.25 / L)
    d_s12 = ts * s(x) * s(0.5 - x) * s(y) * s(0.5 - y) / s_q ** 3
    return torch.stack([d_u, d_v, d_s11, d_s22, d_s12])


def analytic_part(p):
    """Closed-form particular solution [P_u, P_v, P_s11, P_s22, P_s12].

    Zero except s11, a linear ramp 2x·load(t) that equals the cyclic load
    on the loaded edge x=0.5 and vanishes on the symmetry edge; load(0) =
    load'(0) = 0 makes the t=0 value and rate ICs exact.
    """
    x, t = p[0], p[2]
    load = 0.5 * torch.sin((2.0 * math.pi / 5.0) * t + 1.5 * math.pi) + 0.5
    z = torch.zeros_like(x)
    return torch.stack([z, z, 2.0 * x * load, z, z])


def build_model(jet_impl: str = "auto", fourier: int = 0,
                fourier_scale: float = 1.0, bc: str = "net"):
    """uv [3]+8*[70]+[5], dist/part [3]+4*[20]+[5].

    ``fourier`` > 0 puts a random-Fourier-feature embedding on the uv net;
    ``bc="analytic"`` swaps the regressed dist/part nets for the closed-form
    factors above.
    """
    spec = FieldSpec(ndim=2, formulation=SECOND_ORDER)
    if bc == "analytic":
        if fourier:
            uv = FourierMLPFieldModel(
                spec=spec, hidden=(70,) * 8, n_features=fourier,
                feature_scale=fourier_scale, normalize=True, lb=LB, ub=UB,
                jet_impl=jet_impl,
            )
        else:
            uv = MLPFieldModel(spec=spec, hidden=(70,) * 8, jet_impl=jet_impl)
        return AnalyticCompositeFieldModel(
            spec=spec, uv_model=uv,
            dist_fn=analytic_dist, part_fn=analytic_part,
        )
    return CompositeFieldModel(
        spec=spec,
        uv_hidden=(70,) * 8,
        dist_hidden=(20,) * 4,
        part_hidden=(20,) * 4,
        jet_impl=jet_impl,
        uv_fourier=fourier,
        uv_fourier_scale=fourier_scale,
        normalize=bool(fourier),
        lb=LB if fourier else None,
        ub=UB if fourier else None,
    )
