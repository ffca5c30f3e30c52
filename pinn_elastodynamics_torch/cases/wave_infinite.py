"""Elastic wave from a cavity source in an effectively infinite domain.

Counterpart of ``pinn_elastodynamics_tpu/cases/wave_infinite.py`` (the
reference's ElasticWaveInfinite/ElasticWave.py:634-772): plane strain,
first-order (7-output) formulation, Ricker-wavelet source on an r=2 circle
at the domain centre, float32 with input normalisation to [-1, 1] (:191).
Soft IC + SRC losses; the top-edge traction-free loss (NB) is computed but
left out of training (:118-119), kept here as a zero-weight component.
Domain [0, 30]², T = 20 (curriculum 10 s → 15 s → 25 s).  The
normalisation's upper time bound is the stage's ``max_t``, so each
curriculum stage builds its own model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..banks import PointBank, make_bank
from ..geometry import sampling as smp
from ..geometry.sources import ricker_wavelet
from ..losses.terms import FieldTarget, LossSpec, PDEResidual
from ..models.fields import FieldSpec, FIRST_ORDER, MLPFieldModel
from ..ops.elasticity import Material, PLANE_STRAIN
from .base import Case, Phase
from .wave_common import collocation_with_refinement, source_bank_points

SRC_C = (15.0, 15.0)
SRC_R = 2.0
# FEM frames, relative to the root of the reference project.
FEM_DIR = "ElasticWaveInfinite/FEM_result"


def build_model(max_t: float = 20.0, jet_impl: str = "auto") -> MLPFieldModel:
    """[3] + 8*[80] + [7] (:645); input normalisation on (:191)."""
    return MLPFieldModel(
        spec=FieldSpec(ndim=2, formulation=FIRST_ORDER),
        hidden=(80,) * 8,
        normalize=True,
        lb=(0.0, 0.0, 0.0),
        ub=(30.0, 30.0, max_t),
        jet_impl=jet_impl,
    )


def build_banks(
    *, max_t: float = 20.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, device="cuda",
) -> Dict[str, PointBank]:
    """Sample every bank (:666-705) on ``device``; the numpy draws are the
    JAX package's, so the banks are equal to its banks."""
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(round(n * scale)))
    lb = (0.0, 0.0, 0.0)
    ub = (30.0, 30.0, max_t)

    # IC: uniform 101×101 grid at t=0 (:666-668).
    n_grid = max(5, int(round(101 * np.sqrt(scale))))
    ic = np.concatenate(
        [smp.cart_grid_2d(0, 30, 0, 30, n_grid),
         np.zeros((n_grid * n_grid, 1))], axis=1,
    )

    # Top edge y=30: 150 × 201 grid (:671-679) — traction-free, excluded.
    x_up = np.linspace(0, 30, s(150))
    t_up = np.linspace(0, max_t, s(201))
    xu, tu = np.meshgrid(x_up, t_up)
    up = np.stack([xu.ravel(), np.full(xu.size, 30.0), tu.ravel()], axis=1)

    # Collocation: 120k bulk + 10k refinement − source disk (:681-686).
    col = collocation_with_refinement(
        rng, lb=lb, ub=ub, n_bulk=s(120000),
        refine_boxes=[(
            (SRC_C[0] - SRC_R - 1, SRC_C[1] - SRC_R - 1, 0.0),
            (2 * (SRC_R + 1), 2 * (SRC_R + 1), max_t),
            s(10000),
        )],
        exclude=(SRC_C[0], SRC_C[1], SRC_R),
    )

    # Ricker source, 200 circle points × 352 time stations (:691-705).
    tt = np.linspace(0, max_t, s(353))[1:]
    src_pts, src_uv = source_bank_points(
        xc=SRC_C[0], yc=SRC_C[1], r=SRC_R, n_circle=s(200), tt=tt,
        amplitude_fn=ricker_wavelet,
    )

    # Independent row shuffles (reference `shuffle`, :627-632,734).
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


def main_loss() -> LossSpec:
    """loss = f_uv + f_s + IC + SRC, with NB evaluated at weight 0 (:104-119)."""
    return LossSpec(
        terms=(
            ("collocation", PDEResidual(plane=PLANE_STRAIN)),
            ("ic", FieldTarget(name="IC", channels=("u", "v", "ut", "vt"))),
            ("src", FieldTarget(name="SRC", channels=("u", "v"), target_key="uv")),
            ("up", FieldTarget(name="NB", channels=("s22", "s12"))),
        ),
        weights=(
            ("f_uv", 1.0), ("f_s", 1.0), ("IC", 1.0), ("SRC", 1.0), ("NB", 0.0),
        ),
    )


def eval_grid(num: int = 201) -> np.ndarray:
    return smp.grid_disk_complement(
        0, 30, 0, 30, num, xc=SRC_C[0], yc=SRC_C[1], r=SRC_R
    )


def build(
    *, max_t: float = 20.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, maxiter: int = 10000,
    jet_impl: str = "auto", device="cuda",
) -> Case:
    """The infinite-domain wave case with its banks on ``device``
    (``"cuda"`` unless the caller asks for the CPU)."""
    ftol = 1e-3 * float(np.finfo(np.float64).eps)  # :128
    return Case(
        name="elastic_wave_infinite",
        model=build_model(max_t, jet_impl=jet_impl),
        material=Material(E=2.5, mu=0.25, rho=1.0),
        plane=PLANE_STRAIN,
        loss=main_loss(),
        banks=build_banks(
            max_t=max_t, seed=seed, scale=scale, dtype=dtype,
            pad_to_multiple_of=pad_to_multiple_of, device=device,
        ),
        phases=(Phase("uv", main_loss(), maxiter=maxiter, ftol=ftol),),
        lb=(0.0, 0.0, 0.0),
        ub=(30.0, 30.0, max_t),
        n_frames=int(max_t * 4 + 1),
        fem_dir=FEM_DIR,
        fem_offset=(-30.0, -30.0),
        eval_grid=eval_grid(),
        device=device,
    )
