"""3D elastodynamics (BASELINE.json config #4).

Counterpart of ``pinn_elastodynamics_tpu/cases/elastic3d.py``: the
reference's 2D pattern lifted to vector displacement + 6-component stress in
a cube, with a spherical-cavity radial source (the 3D analog of the wave
cases' circular source), soft IC + SRC losses and the first-order
(12-output) formulation, so only first derivatives are needed — the
structure of ElasticWaveConfined (ElasticWave.py:282-348) in 3D.  Also the
plane-P-wave manufactured solution (``build_mms``, ``mms_errors``), the
accuracy oracle of the 3D case.

``build`` and ``build_mms`` take ``jet_impl`` (default ``"auto"``: the fused
kernels on a CUDA tensor), as the wave cases' ``build`` functions do; the
JAX ``build_model`` leaves the main net on the plain jet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..banks import PointBank, make_bank
from ..device import resolve_device
from ..geometry import sampling as smp
from ..geometry.sources import gaussian_pulse
from ..losses.terms import FieldTarget, LossSpec, PDEResidual
from ..models.fields import FieldSpec, FIRST_ORDER, MLPFieldModel
from ..models.mlp import _normalize
from ..ops.elasticity import ISOTROPIC_3D, Material
from ..ops.jet import Jet
from ..utils.tree import tree_leaves
from .base import Case, Phase

SRC_R = 2.0
HALF = 15.0


def build_model(max_t: float = 10.0, jet_impl: str = "auto") -> MLPFieldModel:
    """[4] + 6*[100] + [12], inputs normalised to the cube × [0, max_t]."""
    return MLPFieldModel(
        spec=FieldSpec(ndim=3, formulation=FIRST_ORDER),
        hidden=(100,) * 6,
        normalize=True,
        lb=(-HALF, -HALF, -HALF, 0.0),
        ub=(HALF, HALF, HALF, max_t),
        jet_impl=jet_impl,
    )


def _sphere_points(n: int, rng) -> np.ndarray:
    """Uniform points on the unit sphere (Gaussian normalization)."""
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def build_banks(
    *, max_t: float = 10.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, device="cuda",
) -> Dict[str, PointBank]:
    """Sample every bank on ``device``; the numpy draws are the JAX
    package's, so the banks are equal to its banks."""
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(round(n * scale)))
    lb = (-HALF, -HALF, -HALF, 0.0)
    ub = (HALF, HALF, HALF, max_t)

    # Collocation: bulk + source refinement − cavity.
    col = smp.lhs_box(lb, ub, s(200000), rng)
    ref_box = smp.edge_lhs(
        (-SRC_R - 1, -SRC_R - 1, -SRC_R - 1, 0.0),
        (2 * (SRC_R + 1),) * 3 + (max_t,), s(30000), rng,
    )
    col = np.concatenate([col, ref_box], axis=0)
    rad = np.linalg.norm(col[:, :3], axis=1)
    col = col[rad > SRC_R]

    # IC at t=0 minus cavity.
    ic = smp.edge_lhs(lb, (2 * HALF,) * 3 + (0.0,), s(20000), rng)
    ic = ic[np.linalg.norm(ic[:, :3], axis=1) > SRC_R]

    # Spherical source: radial displacement with a Gaussian pulse.
    sph = _sphere_points(s(500), rng) * SRC_R
    tt = np.linspace(0, max_t, s(101))[1:]
    src = smp.cross_time(sph, tt)
    amp = gaussian_pulse(src[:, 3:4])
    uvw = amp * src[:, 0:3] / SRC_R

    mk = lambda pts, vals=None: make_bank(
        pts, vals, dtype=dtype, pad_to_multiple_of=pad_to_multiple_of,
        device=device,
    )
    return {
        "collocation": mk(col),
        "src": mk(src, {"uvw": uvw}),
        "ic": mk(ic),
    }


def main_loss() -> LossSpec:
    return LossSpec(
        terms=(
            ("collocation", PDEResidual(plane=ISOTROPIC_3D)),
            ("src", FieldTarget(
                name="SRC", channels=("u", "v", "w"), target_key="uvw"
            )),
            ("ic", FieldTarget(
                name="IC", channels=("u", "v", "w", "ut", "vt", "wt")
            )),
        ),
        weights=(("f_uv", 5.0), ("f_s", 5.0), ("SRC", 1.0), ("IC", 1.0)),
    )


# ---------------------------------------------------------------------------
# Manufactured-solution (MMS) oracle — the falsifiable accuracy bar for 3D.
#
# 3D has no FEM data.  A plane P-wave
#     u(x, t) = A n sin(k n·x − ω t),   ω = c_p k,  c_p² = (λ + 2G)/ρ
# solves homogeneous 3D elastodynamics exactly, so (a) an analytically
# constructed jet must zero every residual of ops/residuals.py::residuals_3d,
# and (b) a network trained against its boundary/initial data has a
# closed-form error oracle everywhere in the domain.
# ---------------------------------------------------------------------------

MMS_HALF = 1.0
MMS_T = 2.0


def _mms_coeffs(mat: Material, amp: float, k: float, n_dir):
    n = np.asarray(n_dir, np.float64)
    n = n / np.linalg.norm(n)
    lam = float(mat.E * mat.mu / ((1 + mat.mu) * (1 - 2 * mat.mu)))
    g = float(mat.E / (2 * (1 + mat.mu)))
    cp = np.sqrt((lam + 2 * g) / float(mat.rho))
    return n, lam, g, amp, k, cp * k  # n, λ, G, A, k, ω


def mms_fields(
    xyzt: np.ndarray, mat: Material, *, amp: float = 0.1,
    k: float = np.pi, n_dir=(1.0, 2.0, 2.0),
) -> dict:
    """All 12 first-order channels of the plane P-wave at (x, y, z, t)."""
    n, lam, g, a, k, w = _mms_coeffs(mat, amp, k, n_dir)
    phase = k * (xyzt[:, :3] @ n) - w * xyzt[:, 3]
    sin, cos = np.sin(phase), np.cos(phase)
    out = {}
    for i, c in enumerate(("u", "v", "w")):
        out[c] = a * n[i] * sin
        out[c + "t"] = -a * n[i] * w * cos
    for (i, j), c in zip(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)),
                         ("s11", "s22", "s33", "s12", "s13", "s23")):
        cij = a * k * ((lam if i == j else 0.0) + 2 * g * n[i] * n[j])
        out[c] = cij * cos
    return out


def mms_jet(xyzt: np.ndarray, mat: Material, *, amp: float = 0.1,
            k: float = np.pi, n_dir=(1.0, 2.0, 2.0), device="cuda") -> Jet:
    """Analytic first-order Jet of the plane wave, float64 on ``device`` —
    feeds residuals_3d directly (no network), pinning the residual operator
    itself."""
    spec = FieldSpec(ndim=3, formulation=FIRST_ORDER)
    n, lam, g, a, k, w = _mms_coeffs(mat, amp, k, n_dir)
    phase = k * (xyzt[:, :3] @ n) - w * xyzt[:, 3]
    sin, cos = np.sin(phase), np.cos(phase)
    N = xyzt.shape[0]
    f = np.zeros((N, 12))
    d = np.zeros((4, N, 12))
    ch = spec.index
    for i, (uc, vc) in enumerate((("u", "ut"), ("v", "vt"), ("w", "wt"))):
        f[:, ch(uc)] = a * n[i] * sin
        f[:, ch(vc)] = -a * n[i] * w * cos
        for j in range(3):
            d[j, :, ch(uc)] = a * n[i] * k * n[j] * cos
            d[j, :, ch(vc)] = a * n[i] * w * k * n[j] * sin
        d[3, :, ch(uc)] = -a * n[i] * w * cos
        d[3, :, ch(vc)] = -a * n[i] * w * w * sin
    for (i, j), c in zip(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)),
                         ("s11", "s22", "s33", "s12", "s13", "s23")):
        cij = a * k * ((lam if i == j else 0.0) + 2 * g * n[i] * n[j])
        f[:, ch(c)] = cij * cos
        for jj in range(3):
            d[jj, :, ch(c)] = -cij * k * n[jj] * sin
        d[3, :, ch(c)] = cij * w * sin
    dev = resolve_device(device)
    tensor = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    return Jet(f=tensor(f), d=tensor(d), dtt=None)


def _mms_targets(pts, mat, channels, **kw):
    fields = mms_fields(pts, mat, **kw)
    return np.stack([fields[c] for c in channels], axis=1)


MMS_MATERIAL = Material(E=2.5, mu=0.25, rho=1.0)


def build_mms(
    *, max_t: float = MMS_T, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, maxiter: int = 5000,
    amp: float = 0.1, k: float = np.pi, n_dir=(1.0, 2.0, 2.0),
    jet_impl: str = "auto", device="cuda",
) -> Case:
    """Plane-wave MMS case: PDE residual in the bulk + exact boundary/IC
    data, 4 -> 64 x 5 -> 12 normalised; accuracy is measured against the
    closed-form solution (mms_errors)."""
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(round(n * scale)))
    lb = (-MMS_HALF,) * 3 + (0.0,)
    ub = (MMS_HALF,) * 3 + (max_t,)
    kw = dict(amp=amp, k=k, n_dir=n_dir)
    mat = MMS_MATERIAL

    col = smp.lhs_box(lb, ub, s(80000), rng)

    # Boundary: LHS on each cube face × time.
    faces = []
    for axis in range(3):
        for side in (-MMS_HALF, MMS_HALF):
            face = smp.lhs_box(lb, ub, s(4000), rng)
            face[:, axis] = side
            faces.append(face)
    bc = np.concatenate(faces, axis=0)
    bc_targets = _mms_targets(bc, mat, ("u", "v", "w"), **kw)

    ic = smp.lhs_box(lb, (MMS_HALF,) * 3 + (0.0,), s(15000), rng)
    ic[:, 3] = 0.0
    ic_channels = ("u", "v", "w", "ut", "vt", "wt")
    ic_targets = _mms_targets(ic, mat, ic_channels, **kw)

    mk = lambda pts, vals=None: make_bank(
        pts, vals, dtype=dtype, pad_to_multiple_of=pad_to_multiple_of,
        device=device,
    )
    loss = LossSpec(
        terms=(
            ("collocation", PDEResidual(plane=ISOTROPIC_3D)),
            ("bc", FieldTarget(name="BC", channels=("u", "v", "w"),
                               target_key="uvw")),
            ("ic", FieldTarget(name="IC", channels=ic_channels,
                               target_key="ic")),
        ),
        weights=(("f_uv", 1.0), ("f_s", 1.0), ("BC", 5.0), ("IC", 5.0)),
    )
    model = MLPFieldModel(
        spec=FieldSpec(ndim=3, formulation=FIRST_ORDER),
        hidden=(64,) * 5,
        normalize=True, lb=lb, ub=ub,
        jet_impl=jet_impl,
    )
    return Case(
        name="elastic3d_mms",
        model=model,
        material=mat,
        plane=ISOTROPIC_3D,
        loss=loss,
        banks={
            "collocation": mk(col),
            "bc": mk(bc, {"uvw": bc_targets}),
            "ic": mk(ic, {"ic": ic_targets}),
        },
        phases=(Phase("uv", loss, maxiter=maxiter),),
        lb=lb,
        ub=ub,
        device=device,
    )


def mms_errors(
    model, params, *, n: int = 20000, times=(0.5, 1.0, 1.5), seed: int = 7,
    amp: float = 0.1, k: float = np.pi, n_dir=(1.0, 2.0, 2.0),
) -> Dict[str, float]:
    """Relative L2 error of every channel against the closed-form solution.

    As in the JAX package, the points are rounded to float32 and a
    normalising model scales them in float32 (its ``_normalize`` takes the
    points' dtype); they then take the parameters' dtype and device."""
    leaf = tree_leaves(params)[0]
    norm = getattr(model, "normalize", False)
    net = dataclasses.replace(model, normalize=False) if norm else model
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-MMS_HALF, MMS_HALF, size=(n, 3))
    errs: Dict[str, list] = {}
    spec = model.spec
    for t in times:
        pts = np.concatenate([xyz, np.full((n, 1), t)], axis=1)
        truth = mms_fields(pts, MMS_MATERIAL, amp=amp, k=k, n_dir=n_dir)
        x = torch.as_tensor(pts, dtype=torch.float32, device=leaf.device)
        if norm:
            x = _normalize(x, model.lb, model.ub)
        with torch.no_grad():
            pred = net.apply(params, x.to(leaf.dtype)).double().cpu().numpy()
        for c in spec.channels:
            errs.setdefault(c, [[], []])
            errs[c][0].append(pred[:, spec.index(c)])
            errs[c][1].append(truth[c])
    out = {}
    for c, (p, r) in errs.items():
        p, r = np.concatenate(p), np.concatenate(r)
        out[c] = float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))
    return out


def build(
    *, max_t: float = 10.0, seed: int = 1111, scale: float = 1.0,
    dtype=torch.float32, pad_to_multiple_of: int = 1, maxiter: int = 50000,
    jet_impl: str = "auto", device="cuda",
) -> Case:
    """The 3D case with its banks on ``device`` (``"cuda"`` unless the
    caller asks for the CPU)."""
    return Case(
        name="elastic_wave_3d",
        model=build_model(max_t, jet_impl=jet_impl),
        material=Material(E=2.5, mu=0.25, rho=1.0),
        plane=ISOTROPIC_3D,
        loss=main_loss(),
        banks=build_banks(
            max_t=max_t, seed=seed, scale=scale, dtype=dtype,
            pad_to_multiple_of=pad_to_multiple_of, device=device,
        ),
        phases=(Phase("uv", main_loss(), maxiter=maxiter),),
        lb=(-HALF, -HALF, -HALF, 0.0),
        ub=(HALF, HALF, HALF, max_t),
        device=device,
    )
