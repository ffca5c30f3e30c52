"""Elastic wave in a confined plate: all four edges fixed (u = v = 0).

Counterpart of ``pinn_elastodynamics_tpu/cases/wave_confined.py`` (the
reference's ElasticWaveConfined/ElasticWave.py:881-1026): plane strain,
first-order (7-output) formulation, Gaussian-pulse source on an r=2 circle,
soft IC + SRC + FIX losses; loss = 5·f_uv + 5·f_s + SRC + IC + FIX
(:139-156).  Domain [-15, 15]², T = 14 (curriculum: pretrain at 7 s,
extend).  Material: E=2.5, μ=0.25, ρ=1 (:33-35).  ``bc="hard"`` makes the
edge and initial conditions structural (closed-form factors below).

The reference constructs dist/part networks for this case but never uses
them in the loss; they are omitted here, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..banks import PointBank, make_bank
from ..geometry import sampling as smp
from ..geometry.sources import gaussian_pulse
from ..losses.terms import FieldTarget, LossSpec, PDEResidual
from ..models.analytic_bc import AnalyticCompositeFieldModel
from ..models.fields import FieldSpec, FIRST_ORDER, MLPFieldModel
from ..models.fourier import FourierMLPFieldModel
from ..ops.elasticity import Material, PLANE_STRAIN
from .base import Case, Phase
from .wave_common import collocation_with_refinement, source_bank_points

SRC_C = (0.0, 0.0)
SRC_R = 2.0
# FEM frames, relative to the root of the reference project.
FEM_DIR = "ElasticWaveConfined/FEM_result/30x30_gauss_fine"


def analytic_dist(p):
    """Closed-form distance factors for hard edge/IC enforcement.

    Channels [u, v, ut, vt, s11, s22, s12] (FIRST_ORDER).  The fixed-edge
    condition u = v = 0 on all four edges of [-15, 15]² (:930-938) and the
    zero ICs (:926-928) become structural: u/v get an edge-vanishing spatial
    envelope times tanh²(t) (zero value AND rate at t=0), the velocity
    outputs ut/vt the same envelope times tanh(t), and the stress outputs
    tanh(t) alone (IC only — stresses are free on the edges).  The source
    circle is in no zero set (the pulse is prescribed there, softly, as in
    the reference).
    """
    x, y, t = p[0], p[1], p[2]
    L = 5.0
    s = lambda z: L * torch.tanh(z / L)
    s15 = L * np.tanh(15.0 / L)
    env = (s(x + 15.0) * s(15.0 - x) * s(y + 15.0) * s(15.0 - y)
           / s15 ** 4)
    tv = torch.tanh(t) ** 2   # value + velocity IC (u, v)
    ts = torch.tanh(t)        # value-only IC (ut, vt, stresses)
    d_uv = tv * env
    d_vel = ts * env
    return torch.stack([d_uv, d_uv, d_vel, d_vel, ts, ts, ts])


def analytic_part(p):
    """P = 0: every hard-enforced boundary/initial value is zero here.

    Built from ``p`` so that its device, dtype and vmap batching follow the
    input."""
    return torch.zeros_like(p[0]).expand(7)


def build_model(max_t: float = 14.0, jet_impl: str = "auto",
                bc: str = "soft", fourier: int = 0,
                fourier_scale: float = 1.0, max_t_norm: float = 14.0):
    """[3] + 6*[140] + [7] (:891); no input normalisation (:235).  The
    Fourier embedding normalises to ``max_t_norm``, not ``max_t``."""
    del max_t  # the horizon enters the banks only
    spec = FieldSpec(ndim=2, formulation=FIRST_ORDER)
    if fourier:
        net = FourierMLPFieldModel(
            spec=spec, hidden=(140,) * 6, n_features=fourier,
            feature_scale=fourier_scale, normalize=True,
            lb=(-15.0, -15.0, 0.0), ub=(15.0, 15.0, max_t_norm),
            jet_impl=jet_impl,
        )
    else:
        net = MLPFieldModel(spec=spec, hidden=(140,) * 6, jet_impl=jet_impl)
    if bc == "hard":
        return AnalyticCompositeFieldModel(
            spec=spec, uv_model=net,
            dist_fn=analytic_dist, part_fn=analytic_part,
        )
    return net


def build_banks(
    *, max_t: float = 14.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, device="cuda",
) -> Dict[str, PointBank]:
    """Sample every bank (:926-968) on ``device``; the numpy draws are the
    JAX package's, so the banks are equal to its banks."""
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(round(n * scale)))
    lb = (-15.0, -15.0, 0.0)
    ub = (15.0, 15.0, max_t)

    # IC points minus the source cavity (:926-928).
    ic = smp.edge_lhs(lb, (30.0, 30.0, 0.0), s(6000), rng)
    ic = smp.exclude_disk(ic, xc=SRC_C[0], yc=SRC_C[1], r=SRC_R, strict=True)

    # Four fixed edges, 7000 each (:930-938).
    edges = [
        smp.edge_lhs((-15.0, -15.0, 0.0), (0.0, 30.0, max_t), s(7000), rng),  # LF
        smp.edge_lhs((15.0, -15.0, 0.0), (0.0, 30.0, max_t), s(7000), rng),   # RT
        smp.edge_lhs((-15.0, -15.0, 0.0), (30.0, 0.0, max_t), s(7000), rng),  # LW
        smp.edge_lhs((-15.0, 15.0, 0.0), (30.0, 0.0, max_t), s(7000), rng),   # UP
    ]
    fixed = np.concatenate(edges, axis=0)

    # Collocation: bulk + source refinement + near-boundary refinement
    # (|x|>12 or |y|>12 filter) − source disk (:940-947).
    near_b = smp.lhs_box(lb, ub, s(50000), rng)
    flag = (np.abs(near_b[:, 0]) > 12) | (np.abs(near_b[:, 1]) > 12)
    near_b = near_b[flag]
    col = collocation_with_refinement(
        rng, lb=lb, ub=ub, n_bulk=s(120000),
        refine_boxes=[(
            (SRC_C[0] - SRC_R - 1, SRC_C[1] - SRC_R - 1, 0.0),
            (2 * (SRC_R + 1), 2 * (SRC_R + 1), max_t),
            s(15000),
        )],
        exclude=None,
    )
    col = np.concatenate([col, near_b], axis=0)
    col = smp.exclude_disk(col, xc=SRC_C[0], yc=SRC_C[1], r=SRC_R, strict=True)

    # Gaussian-pulse source on the r=2 circle; time stations dense near the
    # pulse (:952-968).
    tt = np.concatenate(
        [np.linspace(0, 4, s(141)), np.linspace(4, max_t, s(141))]
    )[1:]
    src_pts, src_uv = source_bank_points(
        xc=SRC_C[0], yc=SRC_C[1], r=SRC_R, n_circle=s(200), tt=tt,
        amplitude_fn=gaussian_pulse,
    )

    mk = lambda pts, vals=None: make_bank(
        pts, vals, dtype=dtype, pad_to_multiple_of=pad_to_multiple_of,
        device=device,
    )
    return {
        "collocation": mk(col),
        "src": mk(src_pts, {"uv": src_uv}),
        "ic": mk(ic),
        "fixed": mk(fixed),
    }


def main_loss(bc: str = "soft") -> LossSpec:
    """loss = 5·f_uv + 5·f_s + SRC + IC + FIX (:156).

    With ``bc="hard"`` the IC and FIX terms are exactly zero by
    construction (analytic_dist), so they are dropped from the spec; the
    remaining value stays comparable to the soft-spec loss of any model.
    """
    terms = [
        ("collocation", PDEResidual(plane=PLANE_STRAIN)),
        ("src", FieldTarget(name="SRC", channels=("u", "v"), target_key="uv")),
    ]
    weights = [("f_uv", 5.0), ("f_s", 5.0), ("SRC", 1.0)]
    if bc != "hard":
        terms += [
            ("ic", FieldTarget(name="IC", channels=("u", "v", "ut", "vt"))),
            ("fixed", FieldTarget(name="FIX", channels=("u", "v"))),
        ]
        weights += [("IC", 1.0), ("FIX", 1.0)]
    return LossSpec(terms=tuple(terms), weights=tuple(weights))


def eval_grid(num: int = 201) -> np.ndarray:
    """201×201 grid minus the source disk (:1029-1038)."""
    return smp.grid_disk_complement(
        -15, 15, -15, 15, num, xc=SRC_C[0], yc=SRC_C[1], r=SRC_R
    )


def build(
    *, max_t: float = 14.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, maxiter: int = 100000,
    jet_impl: str = "auto", bc: str = "soft", fourier: int = 0,
    fourier_scale: float = 1.0, device="cuda",
) -> Case:
    """The confined-wave case with its banks on ``device`` (``"cuda"``
    unless the caller asks for the CPU)."""
    ftol = float(np.finfo(np.float64).eps)  # ftol = 1·eps (:166)
    # The Fourier input normalisation is pinned to the FINAL horizon (14 s)
    # so the embedding is the same across curriculum stages and
    # warm-started params keep their meaning.
    return Case(
        name="elastic_wave_confined",
        model=build_model(max_t, jet_impl=jet_impl, bc=bc, fourier=fourier,
                          fourier_scale=fourier_scale, max_t_norm=14.0),
        material=Material(E=2.5, mu=0.25, rho=1.0),
        plane=PLANE_STRAIN,
        loss=main_loss(bc),
        banks=build_banks(
            max_t=max_t, seed=seed, scale=scale, dtype=dtype,
            pad_to_multiple_of=pad_to_multiple_of, device=device,
        ),
        phases=(Phase("uv", main_loss(bc), maxiter=maxiter, ftol=ftol),),
        lb=(-15.0, -15.0, 0.0),
        ub=(15.0, 15.0, max_t),
        n_frames=int(max_t * 4 + 1),
        fem_dir=FEM_DIR,
        fem_offset=(-15.0, -15.0),
        eval_grid=eval_grid(),
        device=device,
    )
