"""Quantitative error metrics against FEM ground truth.

Counterpart of ``pinn_elastodynamics_tpu/eval/metrics.py``, a numpy copy.
The reference validates only visually (side-by-side scatter contours,
SURVEY.md §4); these metrics make that check quantitative: relative L2 error
per field per frame, aggregated across frames.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def relative_l2(pred: np.ndarray, ref: np.ndarray, eps: float = 1e-30) -> float:
    """||pred - ref||₂ / ||ref||₂."""
    pred = np.asarray(pred).ravel()
    ref = np.asarray(ref).ravel()
    return float(np.linalg.norm(pred - ref) / (np.linalg.norm(ref) + eps))


def field_errors(
    pred: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
    fields: Sequence[str] = ("u", "v", "s11", "s22", "s12"),
    *,
    min_ref_rms: float = 1e-6,
) -> Dict[str, float]:
    """Relative L2 per field; fields whose reference RMS is below
    ``min_ref_rms`` are skipped (e.g. the all-zero t=0 rest state, where a
    relative metric is degenerate)."""
    out = {}
    for f in fields:
        if f not in ref:
            continue
        r = np.asarray(ref[f]).ravel()
        if np.sqrt(np.mean(r * r)) < min_ref_rms:
            continue
        out[f] = relative_l2(pred[f], r)
    return out


def aggregate(per_frame: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Mean relative L2 per field across frames (union of available keys —
    individual frames may skip degenerate fields)."""
    keys = sorted({k for d in per_frame for k in d})
    return {
        k: float(np.mean([d[k] for d in per_frame if k in d])) for k in keys
    }


def von_mises_2d(s11, s22, s12, *, mu: float = 0.0, plane: str = "plane_stress"):
    """Von Mises stress from in-plane components.

    plane_stress: s33 = 0; plane_strain: s33 = mu*(s11+s22) (the out-of-plane
    reaction) — matching the FEM 'Mises' field shipped with the wave cases.
    """
    s33 = mu * (s11 + s22) if plane == "plane_strain" else 0.0
    return np.sqrt(
        0.5 * ((s11 - s22) ** 2 + (s22 - s33) ** 2 + (s33 - s11) ** 2)
        + 3.0 * s12 ** 2
    )
