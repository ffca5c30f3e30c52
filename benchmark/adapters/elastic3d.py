"""E1, the 3D elastic wave: its banks from the seed, the program's loss
over them, and the work it needs.

The banks are the program's (``cases/elastic3d.py::build_banks``) drawn by
the benchmark's frozen samplers in the same order, so that one seed gives
both the same rows: an LHS box over the cube × [0, max_t] and a refinement
box around the source, both cut to the outside of the r = 2 cavity; the
IC rows at t = 0, cut the same way; the source, unit-sphere points from
normalised Gaussians at r = 2 crossed with a time grid, whose displacement
is the radial Gaussian pulse.  Points keep the key ``xyt``, with four
columns (x, y, z, t).  The case has one phase, over every parameter.
"""

from __future__ import annotations

import numpy as np

from .. import flops as fl
from .. import samplers as smp
from ..weights import program_tree
from .plate_netbc import program_banks

SRC_R = 2.0
HALF = 15.0
REFERENCE = "elastic3d"
TRAINABLE = "net"
STREAMS = 5   # the value and the x, y, z, t tangents


def sphere_points(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` points on the unit sphere: normal draws over their norm."""
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def outside_ball(pts: np.ndarray, r: float) -> np.ndarray:
    """Rows whose (x, y, z) lie strictly outside the ball of radius ``r``
    at the origin."""
    return pts[np.linalg.norm(pts[:, :3], axis=1) > r]


def banks(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    scale, max_t = cfg["scale"], cfg["max_t"]
    s = lambda n: max(8, int(round(n * scale)))
    lb = (-HALF, -HALF, -HALF, 0.0)
    ub = (HALF, HALF, HALF, max_t)
    col = np.concatenate([
        smp.lhs_box(lb, ub, s(200000), rng),
        smp.edge_lhs((-SRC_R - 1,) * 3 + (0.0,),
                     (2 * (SRC_R + 1),) * 3 + (max_t,), s(30000), rng)])
    col = outside_ball(col, SRC_R)
    ic = outside_ball(smp.edge_lhs(lb, (2 * HALF,) * 3 + (0.0,), s(20000),
                                   rng), SRC_R)
    sph = sphere_points(s(500), rng) * SRC_R
    src = smp.cross_time(sph, np.linspace(0, max_t, s(101))[1:])
    uvw = smp.gaussian_pulse(src[:, 3:4]) * src[:, 0:3] / SRC_R
    return {"collocation": {"xyt": col}, "src": {"xyt": src, "uvw": uvw},
            "ic": {"xyt": ic}}


def program(cfg: dict, banks: dict, weights: dict, device, fault=None):
    """(sub_fn, sub0): the program's one phase, over every parameter."""
    from pinn_elastodynamics_torch.cases import elastic3d
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn

    case = elastic3d.build(scale=1e-3, max_t=cfg["max_t"], device=device)
    norm = cfg["input_normalisation"]
    if (list(case.model.lb), list(case.model.ub)) != (norm["lb"], norm["ub"]):
        raise ValueError(f"the program normalises to {case.model.lb}, "
                         f"{case.model.ub}, not the configuration's {norm}")
    case.banks = program_banks(cfg, banks, device, fault)
    phase = case.phases[-1]
    if phase.trainable is not None:
        raise RuntimeError(f"E1's phase trains {phase.trainable!r}")
    sub_fn, sub0, _ = _phase_loss_fn(case, phase,
                                     program_tree(weights[TRAINABLE]))
    return sub_fn, sub0


def reference_nets(weights: dict, trainable, precision: str, device) -> dict:
    return {TRAINABLE: trainable}


def real_rows(banks: dict) -> int:
    return banks["collocation"]["xyt"].shape[0]


def train_flops(cfg: dict, banks: dict) -> dict:
    """Operations of one value+grad of the loss (``step``): the order-1
    jet (value and four tangents) on the collocation rows, the plain
    forward on the source and IC rows; and of the backward stage B2 per
    launch (``bwd``: the collocation rows' backward)."""
    dims = cfg["nets"][TRAINABLE]
    n_col = real_rows(banks)
    other = sum(banks[k]["xyt"].shape[0] for k in ("src", "ic"))
    step = (n_col * fl.value_and_grad(dims, STREAMS)
            + other * fl.value_and_grad(dims, 1))
    # the seed streams read, their value rows' cotangent written, the
    # stream cotangents read.
    a = dims[0]
    bwd_bytes = n_col * 4 * (STREAMS * a + a + STREAMS * dims[-1])
    return {"step": float(step), "bwd": float(n_col * fl.bwd(dims, STREAMS)),
            "bwd_bytes": float(bwd_bytes)}
