"""Visualization: PINN-vs-FEM comparison figures.

Counterpart of ``pinn_elastodynamics_tpu/eval/plots.py``.  It covers the
reference's plotting layer (~45% of its code, SURVEY.md §2 #21):
  * side-by-side scatter contours of u, v and the stress components per
    frame (postProcess / postProcessDef, train.py:678-855), with optional
    deformed-configuration offset (scale factor);
  * hole-edge stress vs angle comparison (train.py:1004-1101);
  * residual-error maps (the fixed version of ElasticWaveConfined's broken
    plotResidual, SURVEY.md §2.4);
  * loss-history curves.
Figures are written as PNG sequences suitable for GIF assembly.  The
fields come from :func:`~.render.predict_fields` on the case's device, in
the parameters' dtype; FEM frames are read under ``fem_root`` (see
:mod:`.compare`).  This module imports matplotlib (and PIL in
:func:`assemble_gif`); nothing else in the package imports it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import torch

from ..cases.base import Case
from ..ops import residuals as res_ops
from ..utils.tree import tree_leaves
from . import fem
from .compare import fem_path
from .render import predict_fields

_FIELD_LABELS = {
    "u": r"$u$", "v": r"$v$", "s11": r"$\sigma_{11}$",
    "s22": r"$\sigma_{22}$", "s12": r"$\sigma_{12}$", "amp": r"$|u|$",
}


def _dtype(params):
    """The numpy dtype of the parameters, in which the points are fed."""
    return torch.empty(0, dtype=tree_leaves(params)[0].dtype).numpy().dtype


def _panel(ax, x, y, c, title, lims, vmin=None, vmax=None, s=4):
    cf = ax.scatter(x, y, c=c, cmap="rainbow", s=s, marker="s",
                    edgecolors="none", alpha=0.8, vmin=vmin, vmax=vmax)
    ax.axis("square")
    ax.set_xticks([])
    ax.set_yticks([])
    for spine in ax.spines.values():
        spine.set_visible(False)
    ax.set_xlim(lims[:2])
    ax.set_ylim(lims[2:])
    ax.set_title(title, fontsize=12)
    plt.colorbar(cf, fraction=0.046, pad=0.04, ax=ax)


def comparison_figure(
    case: Case, params, frame: int, out_dir: str, *,
    fields: Sequence[str] = ("u", "v", "s11", "s22", "s12"),
    deform_scale: float = 0.0, s: int = 4, dpi: int = 120,
    fem_root: str = ".",
) -> str:
    """PINN (top row) vs FEM (bottom row) scatter contours for one frame."""
    os.makedirs(out_dir, exist_ok=True)
    ref = fem.load_frame(fem_path(case, fem_root), frame)
    ox, oy = case.fem_offset
    x, y = ref["x"] + ox, ref["y"] + oy
    t = case.frame_time(frame)
    pred = predict_fields(case.model, params, np.stack([x, y], 1), t,
                          dtype=_dtype(params), device=case.device)

    lims = (case.lb[0], case.ub[0], case.lb[1], case.ub[1])
    xp = x + deform_scale * pred["u"]
    yp = y + deform_scale * pred["v"]
    xr = x + deform_scale * ref["u"]
    yr = y + deform_scale * ref["v"]

    n = len(fields)
    fig, axes = plt.subplots(2, n, figsize=(3.2 * n, 6.4))
    if n == 1:
        axes = axes[:, None]
    for j, f in enumerate(fields):
        lab = _FIELD_LABELS.get(f, f)
        vmin = min(pred[f].min(), ref[f].min())
        vmax = max(pred[f].max(), ref[f].max())
        _panel(axes[0, j], xp, yp, pred[f], f"{lab}-PINN", lims, vmin, vmax, s)
        _panel(axes[1, j], xr, yr, ref[f], f"{lab}-FEM", lims, vmin, vmax, s)
    fig.suptitle(f"{case.name}  t = {t:.3f}", fontsize=13)
    path = os.path.join(out_dir, f"comparison_{frame:04d}.png")
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return path


def frame_sequence(
    case: Case, params, out_dir: str,
    frames: Optional[Sequence[int]] = None, **kw,
) -> list:
    """PNG sequence over frames (the reference's ./output GIF inputs)."""
    if frames is None:
        frames = range(case.n_frames)
    return [comparison_figure(case, params, i, out_dir, **kw) for i in frames]


def hole_edge_stress_figure(
    case: Case, params, out_path: str, *,
    times: Sequence[float] = (2.5, 3.75, 5.0),
    r: float = 0.1, n_theta: int = 100, dpi: int = 150,
    fem_root: str = ".",
) -> str:
    """Hole-edge stress vs angle, PINN curves vs FEM scatter
    (train.py:1004-1101), one subplot per stress component."""
    theta = np.linspace(0.0, np.pi / 2, n_theta)
    xy = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    fig, axes = plt.subplots(1, 3, figsize=(14, 4.5))
    colors = plt.cm.viridis(np.linspace(0, 0.9, len(times)))
    for comp_i, comp in enumerate(("s11", "s22", "s12")):
        ax = axes[comp_i]
        for color, t in zip(colors, times):
            pred = predict_fields(case.model, params, xy, t,
                                  dtype=_dtype(params), device=case.device)
            ax.plot(np.degrees(theta), pred[comp], "-", color=color,
                    label=f"t={t}s PINN")
            # FEM points on the hole edge.
            frame = round(t / case.frame_time(1))
            ref = fem.load_frame(fem_path(case, fem_root), frame)
            ox, oy = case.fem_offset
            xr, yr = ref["x"] + ox, ref["y"] + oy
            mask = (xr**2 + yr**2) <= (r**2 + 1e-6)
            ang = np.degrees(np.arccos(np.clip(xr[mask] / r, -1, 1)))
            ax.scatter(ang, ref[comp][mask], marker="^", s=8, color=color,
                       label=f"t={t}s FEM")
        ax.set_xlim(0, 90)
        ax.set_xlabel(r"$\theta$ / degree")
        ax.set_ylabel(_FIELD_LABELS[comp])
        ax.legend(fontsize=7, frameon=False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return out_path


def residual_map_figure(
    case: Case, params, t: float, out_path: str, *,
    num: int = 151, dpi: int = 120,
) -> str:
    """|momentum residual| map on the eval grid at time t — the working
    version of the reference's broken plotResidual (SURVEY.md §2.4)."""
    grid = case.eval_grid
    assert grid is not None, "case has no eval grid"
    xyt = np.concatenate(
        [grid, np.full((grid.shape[0], 1), t)], axis=1
    ).astype(np.float32)
    like = tree_leaves(params)[0]
    with torch.no_grad():
        jet = case.model.jet(params, torch.as_tensor(
            xyt, device=like.device).to(like.dtype))
        res = res_ops.residuals(jet, case.model.spec, case.material,
                                case.plane)
        r = torch.sqrt(res["f_u"] ** 2 + res["f_v"] ** 2).cpu().numpy()
    fig, ax = plt.subplots(figsize=(5, 4.5))
    lims = (case.lb[0], case.ub[0], case.lb[1], case.ub[1])
    _panel(ax, grid[:, 0], grid[:, 1], r, f"|momentum residual|  t={t}", lims)
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return out_path


def loss_history_figure(
    histories: Dict[str, np.ndarray], out_path: str, *, dpi: int = 120
) -> str:
    """Per-component loss curves (SemiInfinite's loss.pickle analog)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, h in histories.items():
        ax.semilogy(np.asarray(h), label=name)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path


def assemble_gif(paths: Sequence[str], out_path: str, *, fps: int = 8) -> str:
    """PNG sequence → GIF (the reference ships GIF results)."""
    from PIL import Image

    frames = [Image.open(p) for p in paths]
    frames[0].save(
        out_path, save_all=True, append_images=frames[1:],
        duration=int(1000 / fps), loop=0,
    )
    return out_path
