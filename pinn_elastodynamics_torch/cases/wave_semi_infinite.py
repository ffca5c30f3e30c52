"""Elastic wave in a semi-infinite domain: traction-free top surface.

Counterpart of ``pinn_elastodynamics_tpu/cases/wave_semi_infinite.py`` (the
reference's ElasticWaveSemiInfinite/ElasticWave.py:667-790): plane strain,
first-order (7-output) formulation, Ricker-wavelet source on an r=2 circle
at the origin, soft IC + SRC + free-surface (NB) losses;
loss = 5·f_uv + 5·f_s + 2·IC + 2·SRC + 2·NB (:112-127).
Domain [-15, 15]², T = 16 (curriculum: pretrain at 8 s, extend to 16 s).

Kept from the JAX package as it is: its Fourier model is built without
``jet_impl``, so it runs the plain jet (XLA there, eager here) whatever the
caller asks for.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..banks import PointBank, make_bank
from ..geometry import sampling as smp
from ..geometry.sources import ricker_wavelet
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
FEM_DIR = "ElasticWaveSemiInfinite/FEM_result"


def analytic_dist(p):
    """Closed-form distance factors for hard IC + free-surface enforcement.

    Channels [u, v, ut, vt, s11, s22, s12]: u/v get tanh²(t) (zero value
    AND rate at t=0 — there are no displacement BCs on a truncated
    semi-infinite domain), ut/vt/s11 get tanh(t), and the traction-free
    surface σ22 = σ12 = 0 on y = 15 (:697-700) multiplies those two
    channels by a surface-vanishing envelope.  The Ricker source stays a
    soft term (prescribed nonzero displacement on the circle).
    """
    y, t = p[1], p[2]
    e_up = torch.tanh((15.0 - y) / 5.0)
    tv = torch.tanh(t) ** 2
    ts = torch.tanh(t)
    return torch.stack([tv, tv, ts, ts, ts, ts * e_up, ts * e_up])


def analytic_part(p):
    """P = 0: every hard-enforced boundary/initial value is zero here.

    Built from ``p`` so that its device, dtype and vmap batching follow the
    input."""
    return torch.zeros_like(p[0]).expand(7)


def build_model(max_t: float = 16.0, jet_impl: str = "auto",
                fourier: int = 0, fourier_scale: float = 1.0,
                bc: str = "soft", max_t_norm: float = 16.0):
    """[3] + 8*[100] + [7] (:679); no input normalisation (:198).

    ``fourier`` > 0 swaps in the random-Fourier-feature embedding, with
    inputs normalised to the final horizon ``max_t_norm`` so that the
    embedding is the same across curriculum stages.  That model is built
    without ``jet_impl``, as in the JAX package.
    """
    del max_t  # the horizon enters the banks only
    spec = FieldSpec(ndim=2, formulation=FIRST_ORDER)
    if fourier:
        net = FourierMLPFieldModel(
            spec=spec, hidden=(100,) * 8, n_features=fourier,
            feature_scale=fourier_scale, normalize=True,
            lb=(-15.0, -15.0, 0.0), ub=(15.0, 15.0, max_t_norm),
        )
    else:
        net = MLPFieldModel(spec=spec, hidden=(100,) * 8, jet_impl=jet_impl)
    if bc == "hard":
        return AnalyticCompositeFieldModel(
            spec=spec, uv_model=net,
            dist_fn=analytic_dist, part_fn=analytic_part,
        )
    return net


def build_banks(
    *, max_t: float = 16.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, device="cuda",
) -> Dict[str, PointBank]:
    """Sample every bank (:692-739) on ``device``; the numpy draws are the
    JAX package's, so the banks are equal to its banks."""
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(round(n * scale)))
    lb = (-15.0, -15.0, 0.0)
    ub = (15.0, 15.0, max_t)

    # IC: 12k LHS over the square at t=0 (:692-694).
    xy_ic = smp.edge_lhs((-15.0, -15.0), (30.0, 30.0), s(12000), rng)
    ic = np.concatenate([xy_ic, np.zeros((xy_ic.shape[0], 1))], axis=1)

    # Free surface y=15: 15k LHS over (x, t) (:697-700).
    xt_up = smp.edge_lhs((-15.0, 0.0), (30.0, max_t), s(15000), rng)
    up = np.stack(
        [xt_up[:, 0], np.full(xt_up.shape[0], 15.0), xt_up[:, 1]], axis=1
    )

    # Collocation: 120k bulk + source refinement + near-surface refinement
    # − source disk (:702-707).
    col = collocation_with_refinement(
        rng, lb=lb, ub=ub, n_bulk=s(120000),
        refine_boxes=[
            (
                (SRC_C[0] - SRC_R - 2, SRC_C[1] - SRC_R - 2, 0.0),
                (2 * (SRC_R + 2), 2 * (SRC_R + 2), max_t),
                s(15000),
            ),
            ((-15.0, 15.0 - 6.0, 0.0), (30.0, 6.0, max_t), s(20000)),
        ],
        exclude=(SRC_C[0], SRC_C[1], SRC_R),
    )

    # Ricker source, 150 circle points; time dense over the pulse (:725-739).
    tt = np.concatenate(
        [np.linspace(0, 6, s(153)), np.linspace(6, max_t, s(63))]
    )[1:]
    src_pts, src_uv = source_bank_points(
        xc=SRC_C[0], yc=SRC_C[1], r=SRC_R, n_circle=s(150), tt=tt,
        amplitude_fn=ricker_wavelet,
    )

    # Independent row shuffles (:660-664,768).
    col, src_all, ic, up = smp.shuffled(
        rng, col, np.concatenate([src_pts, src_uv], axis=1), ic, up
    )
    src_pts, src_uv = src_all[:, :3], src_all[:, 3:]

    mk = lambda pts, vals=None: make_bank(
        pts, vals, dtype=dtype, pad_to_multiple_of=pad_to_multiple_of,
        device=device,
    )
    return {
        "collocation": mk(col),
        "src": mk(src_pts, {"uv": src_uv}),
        "ic": mk(ic),
        "up": mk(up),
    }


def main_loss(bc: str = "soft") -> LossSpec:
    """loss = 5·f_uv + 5·f_s + 2·IC + 2·SRC + 2·NB (:127).

    With ``bc="hard"`` the IC and NB terms are exactly zero by construction
    (analytic_dist) and drop from the spec; the remaining value stays
    comparable to the soft-spec loss of any model.
    """
    terms = [
        ("collocation", PDEResidual(plane=PLANE_STRAIN)),
        ("src", FieldTarget(name="SRC", channels=("u", "v"), target_key="uv")),
    ]
    weights = [("f_uv", 5.0), ("f_s", 5.0), ("SRC", 2.0)]
    if bc != "hard":
        terms += [
            ("ic", FieldTarget(name="IC", channels=("u", "v", "ut", "vt"))),
            ("up", FieldTarget(name="NB", channels=("s22", "s12"))),
        ]
        weights += [("IC", 2.0), ("NB", 2.0)]
    return LossSpec(terms=tuple(terms), weights=tuple(weights))


def eval_grid(num: int = 201) -> np.ndarray:
    return smp.grid_disk_complement(
        -15, 15, -15, 15, num, xc=SRC_C[0], yc=SRC_C[1], r=SRC_R
    )


def build(
    *, max_t: float = 16.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, maxiter: int = 1000,
    jet_impl: str = "auto", fourier: int = 0, fourier_scale: float = 1.0,
    bc: str = "soft", device="cuda",
) -> Case:
    """The semi-infinite wave case with its banks on ``device`` (``"cuda"``
    unless the caller asks for the CPU)."""
    ftol = 1e-3 * float(np.finfo(np.float64).eps)  # :136
    return Case(
        name="elastic_wave_semi_infinite",
        model=build_model(max_t, jet_impl=jet_impl, fourier=fourier,
                          fourier_scale=fourier_scale, bc=bc, max_t_norm=16.0),
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
        fem_offset=(-45.0, -45.0),
        eval_grid=eval_grid(),
        device=device,
    )
