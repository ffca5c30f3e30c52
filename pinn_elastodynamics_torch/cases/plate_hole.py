"""Quarter plate with a circular hole under cyclic tension — the flagship case.

Counterpart of ``pinn_elastodynamics_tpu/cases/plate_hole.py`` (the
reference's PlateHoleQuarter/train/train.py:871-974): plane stress,
second-order (5-output) formulation, hard BCs via the composite u = P + D·ũ
with dist/part pretraining phases, cyclic traction s11(t) = 0.5·sin(2πt/5 +
3π/2) + 0.5 on the right edge, traction-free hole.  Geometry [0, 0.5]² minus
an r=0.1 quarter-hole at the origin, T = 10; E=20, μ=0.25, ρ=1.  The case
names its FEM comparison frames (81 frames under ``FEM_DIR``, a directory of
the reference project that this repo does not hold) and its evaluation
grid; nothing in the port reads the FEM frames yet.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..banks import PointBank, make_bank
from ..geometry import distance as dist_mod
from ..geometry import sampling as smp
from ..geometry.sources import cyclic_tension
from ..losses.terms import (
    FieldTarget,
    LossSpec,
    PDEResidual,
    Regression,
    Traction,
)
from ..models.analytic_bc import AnalyticCompositeFieldModel
from ..models.fields import (
    CompositeFieldModel,
    FieldSpec,
    MLPFieldModel,
    SECOND_ORDER,
)
from ..models.fourier import FourierMLPFieldModel
from ..ops.elasticity import PLANE_STRESS, Material
from .base import Case, Phase

HOLE_R = 0.1
LB = (0.0, 0.0, 0.0)
UB = (0.5, 0.5, 10.0)
MAX_T = 10.0
# FEM frames, relative to the root of the reference project.
FEM_DIR = "PlateHoleQuarter/FEM_result/Quarter_plate_hole_dynamic"


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


def build_banks(*, seed: int = 1111, scale: float = 1.0, dtype=torch.float32,
                pad_to_multiple_of: int = 1,
                device="cuda") -> Dict[str, PointBank]:
    """Sample all point banks (train.py:893-929) on ``device``.  ``scale``
    < 1 shrinks every count proportionally for fast tests.  The numpy draws
    are the JAX package's, so the banks are equal to its banks."""
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(round(n * scale)))

    # Distance-regression grid + analytic targets.
    n_grid = max(5, int(round(21 * np.sqrt(scale))))
    dist_pts = smp.dist_grid_with_surface(
        xmin=0, xmax=0.5, ymin=0, ymax=0.5, tmin=0, tmax=MAX_T,
        xc=0, yc=0, r=HOLE_R,
        num_surf_pt=s(40), num=n_grid, num_t=n_grid, arc="quarter",
    )
    dist_targets = dist_mod.plate_hole_distance(dist_pts)

    # IC points, t=0.
    ic = smp.lhs_box(LB, (0.5, 0.5, 0.0), s(5000), rng)
    ic = smp.exclude_disk(ic, xc=0, yc=0, r=HOLE_R, strict=True)

    # Collocation: bulk + stress-concentration refinement − hole.
    col = smp.lhs_box(LB, UB, s(70000), rng)
    col_ref = smp.lhs_box(LB, (0.15, 0.15, MAX_T), s(40000), rng)
    col = np.concatenate([col, col_ref], axis=0)
    col = smp.exclude_disk(col, xc=0, yc=0, r=HOLE_R, strict=True)

    # Hole-surface traction points: quarter arc × time stations, skipping
    # t=0.
    arc = smp.circle_points(xc=0, yc=0, r=HOLE_R, n=s(83), theta1=np.pi / 2)
    tt = np.linspace(0.0, MAX_T, s(121))[1:]
    hole = smp.cross_time(arc, tt)
    hole_normals = np.stack(
        [-hole[:, 0] / HOLE_R, -hole[:, 1] / HOLE_R], axis=1
    )

    # Edge banks.
    lw = smp.edge_lhs((0.1, 0.0, 0.0), (0.4, 0.0, MAX_T), s(8000), rng)
    up = smp.edge_lhs((0.0, 0.5, 0.0), (0.5, 0.0, MAX_T), s(8000), rng)
    lf = smp.edge_lhs((0.0, 0.1, 0.0), (0.0, 0.4, MAX_T), s(8000), rng)
    rt = smp.edge_lhs((0.5, 0.0, 0.0), (0.0, 0.5, MAX_T), s(13000), rng)
    s11_rt = cyclic_tension(rt[:, 2:3])

    # Fold subsampled boundary points into the collocation set.
    col = np.concatenate(
        [col, hole[::4], lf[::5], rt[::5], up[::5], lw[::5]], axis=0
    )

    mk = lambda pts, vals=None: make_bank(
        pts, vals, dtype=dtype, pad_to_multiple_of=pad_to_multiple_of,
        device=device,
    )
    return {
        "collocation": mk(col),
        "hole": mk(hole, {"normals": hole_normals}),
        "ic": mk(ic),
        "lf": mk(lf),
        "rt": mk(rt, {"s11": s11_rt}),
        "up": mk(up),
        "lw": mk(lw),
        "dist": mk(dist_pts, {"targets": dist_targets}),
    }


def main_loss() -> LossSpec:
    """loss = 10·(loss_f_uv + loss_f_s + loss_HOLE) (train.py:186-217)."""
    return LossSpec(
        terms=(
            ("collocation", PDEResidual(plane=PLANE_STRESS)),
            ("hole", Traction(name="HOLE")),
        ),
        weights=(("f_uv", 10.0), ("f_s", 10.0), ("HOLE", 10.0)),
    )


def dist_loss() -> LossSpec:
    """loss_DIST: regress the analytic distances and zero ∂D/∂t for u, v at
    the IC (train.py:194-200); trained with a 1000x scale."""
    return LossSpec(
        terms=(
            ("dist", Regression(name="DIST", net="dist")),
            ("ic", FieldTarget(name="DIST", channels=("dt:u", "dt:v"),
                               net="dist")),
        ),
        weights=(("DIST", 1.0),),
    )


def part_loss() -> LossSpec:
    """loss_PART: the particular net alone satisfies every IC/BC
    (train.py:201-215); trained with a 1000x scale."""
    return LossSpec(
        terms=(
            ("ic", FieldTarget(
                name="PART",
                channels=("u", "v", "s11", "s22", "s12", "dt:u", "dt:v"),
                net="part",
            )),
            ("lf", FieldTarget(name="PART", channels=("u", "s12"), net="part")),
            ("rt", FieldTarget(
                name="PART", channels=("s11",), target_key="s11", net="part"
            )),
            ("rt", FieldTarget(name="PART", channels=("s12",), net="part")),
            ("lw", FieldTarget(name="PART", channels=("v", "s12"), net="part")),
            ("up", FieldTarget(name="PART", channels=("s22", "s12"),
                               net="part")),
        ),
        weights=(("PART", 1.0),),
    )


def eval_grid(num: int = 251) -> np.ndarray:
    """The reference's 251×251 grid minus the hole (train.py:980-989)."""
    return smp.grid_disk_complement(
        0.0, 0.5, 0.0, 0.5, num, xc=0, yc=0, r=HOLE_R
    )


def build(
    *,
    seed: int = 1111,
    scale: float = 1.0,
    dtype=torch.float32,
    pad_to_multiple_of: int = 1,
    maxiter_dist: int = 20000,
    maxiter_part: int = 20000,
    maxiter_uv: int = 70000,
    jet_impl: str = "auto",
    fourier: int = 0,
    fourier_scale: float = 1.0,
    bc: str = "net",
    device="cuda",
) -> Case:
    """The plate case with its banks on ``device`` (``"cuda"`` unless the
    caller asks for the CPU)."""
    ftol = 1e-5 * float(np.finfo(np.float64).eps)  # train.py:227
    if bc == "analytic":
        # Exact closed-form D/P: no pretraining phases exist.
        phases = (
            Phase("uv", main_loss(), trainable="uv", scale=1.0,
                  maxiter=maxiter_uv, ftol=ftol),
        )
    else:
        phases = (
            Phase("dist", dist_loss(), trainable="dist", scale=1000.0,
                  maxiter=maxiter_dist, ftol=ftol),
            Phase("part", part_loss(), trainable="part", scale=1000.0,
                  maxiter=maxiter_part, ftol=ftol),
            Phase("uv", main_loss(), trainable="uv", scale=1.0,
                  maxiter=maxiter_uv, ftol=ftol),
        )
    return Case(
        name="plate_hole_quarter",
        model=build_model(jet_impl, fourier, fourier_scale, bc),
        material=Material(E=20.0, mu=0.25, rho=1.0),
        plane=PLANE_STRESS,
        loss=main_loss(),
        banks=build_banks(seed=seed, scale=scale, dtype=dtype,
                          pad_to_multiple_of=pad_to_multiple_of,
                          device=device),
        phases=phases,
        lb=LB,
        ub=UB,
        n_frames=81,
        fem_dir=FEM_DIR,
        eval_grid=eval_grid(),
        device=device,
    )
