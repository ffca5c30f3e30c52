"""Case-level comparison against FEM ground truth.

Counterpart of ``pinn_elastodynamics_tpu/eval/compare.py``: turns the
reference's visual-only validation (side-by-side scatter plots, SURVEY.md
§4) into numbers, per-frame and aggregate relative-L2 errors of every
predicted field at the FEM probe coordinates.  The fields come from
:func:`~.render.predict_fields` on the case's device, so on the GPU a
net-BC plate renders through the composite kernel and a plain-MLP wave
model through the MLP kernel.

The port's cases name ``fem_dir`` relative to the root of the reference
project; ``fem_root`` is that root (default: the current directory).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..cases.base import Case
from . import fem, metrics
from .render import predict_fields

FIELDS = ("u", "v", "s11", "s22", "s12", "amp", "Mises")


def fem_path(case: Case, fem_root: str = ".") -> str:
    """The directory of the case's FEM frames under ``fem_root``."""
    return os.path.join(fem_root, case.fem_dir)


def _frame_data(case: Case, params, frame: int, *, dtype=np.float64,
                fem_root: str = "."):
    """Predicted and FEM field vectors at one frame's probe points."""
    ref = fem.load_frame(fem_path(case, fem_root), frame)
    ox, oy = case.fem_offset
    xy = np.stack([ref["x"] + ox, ref["y"] + oy], axis=1)
    pred = predict_fields(case.model, params, xy, case.frame_time(frame),
                          dtype=dtype, device=case.device)
    pred["Mises"] = metrics.von_mises_2d(
        pred["s11"], pred["s22"], pred["s12"],
        mu=float(np.asarray(case.material.mu)), plane=case.plane,
    )
    return pred, ref


def frame_errors(
    case: Case, params, frame: int, *, dtype=np.float64,
    fem_root: str = ".",
) -> Dict[str, float]:
    """Relative L2 error per field for one FEM frame."""
    pred, ref = _frame_data(case, params, frame, dtype=dtype,
                            fem_root=fem_root)
    return metrics.field_errors(pred, ref, FIELDS)


def _concat_errors(frame_data: Sequence[tuple]) -> Dict[str, float]:
    """Magnitude-weighted relative L2: concatenate each field across frames
    BEFORE the norm (the :func:`hole_edge_errors` protocol).  A per-frame
    mean of relative errors is degenerate when a frame's fields are near
    zero — e.g. the plate's t = 5.0 cyclic-load zero crossing
    (PlateHoleQuarter/train/train.py:918-926), where frame 40's relative
    errors read O(1) noise."""
    preds: Dict[str, List[np.ndarray]] = {}
    refs: Dict[str, List[np.ndarray]] = {}
    for pred, ref in frame_data:
        for f in FIELDS:
            if f not in ref:
                continue
            preds.setdefault(f, []).append(np.asarray(pred[f]).ravel())
            refs.setdefault(f, []).append(np.asarray(ref[f]).ravel())
    out = {}
    for f, chunks in refs.items():
        r = np.concatenate(chunks)
        if np.sqrt(np.mean(r * r)) < 1e-6:
            continue
        out[f] = metrics.relative_l2(np.concatenate(preds[f]), r)
    return out


def hole_edge_errors(
    case: Case, params, times: Sequence[float] = (2.5, 3.75, 5.0),
    *, radius: float = 0.1, dtype=np.float64, fem_root: str = ".",
) -> Dict[str, object]:
    """Quantify the reference's hole-edge stress-vs-θ comparison.

    The reference overlays PINN and FEM stresses along the r=0.1 hole arc
    at t = 2.5/3.75/5.0 s (PlateHoleQuarter/train/train.py:1004-1101, FEM
    points selected by x²+y² <= 0.010001).  Here the PINN is evaluated AT
    the FEM hole-edge probe points and scored: relative L2 per cartesian
    stress channel plus the hoop stress σθθ, per time and aggregated over
    the concatenated times.
    """
    frame_dt = case.max_t / (case.n_frames - 1)
    per_time: List[Dict[str, float]] = []
    channels = ("s11", "s22", "s12", "s_hoop")
    all_pred: Dict[str, List[np.ndarray]] = {k: [] for k in channels}
    all_ref: Dict[str, List[np.ndarray]] = {k: [] for k in channels}
    for t in times:
        frame = int(round(t / frame_dt))
        ref = fem.load_frame(fem_path(case, fem_root), frame)
        ox, oy = case.fem_offset
        x, y = ref["x"] + ox, ref["y"] + oy
        mask = (x**2 + y**2) <= radius**2 + 1e-6  # train.py:1020
        xy = np.stack([x[mask], y[mask]], axis=1)
        pred = predict_fields(case.model, params, xy, t, dtype=dtype,
                              device=case.device)
        # Hoop stress on the arc: σθθ = σ11·sin²θ + σ22·cos²θ − 2σ12·sinθcosθ
        # (tangent direction (−sinθ, cosθ) on the circle).
        ct, st = xy[:, 0] / radius, xy[:, 1] / radius
        ref_c = {k: ref[k][mask] for k in ("s11", "s22", "s12")}
        pred_c = {k: np.asarray(pred[k]).ravel() for k in ("s11", "s22", "s12")}
        ref_c["s_hoop"] = (ref_c["s11"] * st**2 + ref_c["s22"] * ct**2
                           - 2.0 * ref_c["s12"] * st * ct)
        pred_c["s_hoop"] = (pred_c["s11"] * st**2 + pred_c["s22"] * ct**2
                            - 2.0 * pred_c["s12"] * st * ct)
        errs = {k: metrics.relative_l2(pred_c[k], ref_c[k]) for k in channels}
        errs["t"] = float(t)
        per_time.append(errs)
        for k in channels:
            all_pred[k].append(pred_c[k])
            all_ref[k].append(np.asarray(ref_c[k]).ravel())
    # Aggregate over concatenated times: weights each time by its physical
    # magnitude (at load zero-crossings like t=5.0 the fields are ~0 and a
    # per-time relative metric is degenerate).
    agg = {
        k: metrics.relative_l2(
            np.concatenate(all_pred[k]), np.concatenate(all_ref[k])
        )
        for k in channels
    }
    return {"per_time": per_time, "aggregate": agg}


def mid_frames(case: Case) -> List[int]:
    """The reference's own validation frames: quarter-, (3/8)- and
    half-period (plate train.py:992-998 plots t = 2.5/3.75/5.0 of T = 10,
    frames 20/30/40 of 81).  Full-horizon aggregates mix near-zero-field
    early frames and late-time drift, so both are reported."""
    n = case.n_frames - 1
    return sorted({int(round(n / 4)), int(round(3 * n / 8)),
                   int(round(n / 2))})


def compare_frames(
    case: Case, params, frames: Optional[Sequence[int]] = None,
    *, dtype=np.float64, with_mid: bool = True, fem_root: str = ".",
) -> Dict[str, object]:
    """Per-frame + aggregate errors over a frame set (default: all frames).

    With ``with_mid`` the result also carries ``aggregate_mid`` over
    :func:`mid_frames`, magnitude-weighted (fields concatenated across the
    mid frames before the relative L2, see :func:`_concat_errors`);
    ``aggregate`` stays the per-frame mean for frame-set comparability.
    """
    if frames is None:
        frames = range(case.n_frames)
    frames = list(frames)
    errs: Dict[int, Dict[str, float]] = {}
    mids = mid_frames(case) if with_mid else []
    mid_data: Dict[int, tuple] = {}
    for i in sorted(set(frames) | set(mids)):
        data = _frame_data(case, params, i, dtype=dtype, fem_root=fem_root)
        if i in mids:
            mid_data[i] = data
        errs[i] = metrics.field_errors(*data, FIELDS)
    out = {
        "frames": frames,
        "per_frame": [errs[i] for i in frames],
        "aggregate": metrics.aggregate([errs[i] for i in frames]),
    }
    if with_mid:
        out["mid_frames"] = mids
        out["aggregate_mid"] = _concat_errors([mid_data[i] for i in mids])
    return out
