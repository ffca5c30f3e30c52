"""The net-BC quarter plate with a hole: its banks from the seed, the
program's main phase over them, and the work it needs.

The banks are the reference project's (PlateHoleQuarter/train/
train.py:893-929) drawn by the benchmark's frozen samplers in the order the
program's ``cases/plate_hole.py::build_banks`` draws them, so that one seed
gives both the same rows.  The main phase trains ``uv`` with ``dist`` and
``part`` frozen; its loss reads the collocation and hole banks only.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import flops as fl
from .. import samplers as smp
from ..weights import program_tree

HOLE_R = 0.1
MAX_T = 10.0
LB = (0.0, 0.0, 0.0)
UB = (0.5, 0.5, MAX_T)
REFERENCE = "plate_netbc"
TRAINABLE = "uv"


def banks(cfg: dict, seed: int) -> dict:
    """Host arrays (float64, real rows only) of the banks the main loss
    reads."""
    rng = np.random.default_rng(seed)
    scale = cfg["scale"]
    s = lambda n: max(8, int(round(n * scale)))
    smp.lhs_box(LB, (0.5, 0.5, 0.0), s(5000), rng)   # IC rows: not in this loss
    col = np.concatenate([smp.lhs_box(LB, UB, s(70000), rng),
                          smp.lhs_box(LB, (0.15, 0.15, MAX_T), s(40000), rng)])
    col = smp.exclude_disk(col, xc=0.0, yc=0.0, r=HOLE_R)
    arc = smp.circle_points(xc=0.0, yc=0.0, r=HOLE_R, n=s(83),
                            theta1=np.pi / 2)
    hole = smp.cross_time(arc, np.linspace(0.0, MAX_T, s(121))[1:])
    normals = -hole[:, :2] / HOLE_R
    lw = smp.edge_lhs((0.1, 0.0, 0.0), (0.4, 0.0, MAX_T), s(8000), rng)
    up = smp.edge_lhs((0.0, 0.5, 0.0), (0.5, 0.0, MAX_T), s(8000), rng)
    lf = smp.edge_lhs((0.0, 0.1, 0.0), (0.0, 0.4, MAX_T), s(8000), rng)
    rt = smp.edge_lhs((0.5, 0.0, 0.0), (0.0, 0.5, MAX_T), s(13000), rng)
    col = np.concatenate([col, hole[::4], lf[::5], rt[::5], up[::5], lw[::5]])
    return {"collocation": {"xyt": col},
            "hole": {"xyt": hole, "normals": normals}}


def program_banks(cfg: dict, banks: dict, device, fault=None) -> dict:
    """The program's ``PointBank``s of ``banks``, padded as the config
    says.  ``fault="half_batch"`` zeroes the mask of every other row: the
    masked means are then taken over half of each bank."""
    from pinn_elastodynamics_torch.banks import make_bank

    out = {}
    for name, arrays in banks.items():
        values = {k: v for k, v in arrays.items() if k != "xyt"}
        b = make_bank(arrays["xyt"], values, dtype=torch.float32,
                      pad_to_multiple_of=cfg["pad_to_multiple_of"],
                      device=device)
        if fault == "half_batch":
            keep = (torch.arange(b.n_total, device=b.mask.device) % 2) == 0
            b.mask = b.mask * keep.to(b.mask.dtype)
        out[name] = b
    return out


def program(cfg: dict, banks: dict, weights: dict, device, fault=None):
    """(sub_fn, sub0): the program's main-phase loss over the trainable
    subtree, as ``run_pipeline`` hands it to ``minimize``, and the
    subtree's start."""
    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn

    case = plate_hole.build(scale=1e-3, device=device)
    case.banks = program_banks(cfg, banks, device, fault)
    params = {k: program_tree(v) for k, v in weights.items()}
    phase = case.phases[-1]
    if phase.trainable != TRAINABLE:
        raise RuntimeError(f"the plate's main phase trains {phase.trainable!r}")
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    return sub_fn, sub0


def reference_nets(weights: dict, trainable, precision: str, device) -> dict:
    """The reference's nets: ``trainable`` (a list of (W, b)) in place of
    uv, dist and part from the run's weights, in the precision's dtype."""
    from ..reference.mlp import cast_net

    nets = {k: cast_net(v, precision, device) for k, v in weights.items()
            if k != TRAINABLE}
    nets[TRAINABLE] = trainable
    return nets


def real_rows(banks: dict) -> int:
    return banks["collocation"]["xyt"].shape[0]


def train_flops(cfg: dict, banks: dict) -> dict:
    """Operations of one value+grad of the main loss (``step``), and of
    the backward stage B5 as the loss needs it (``bwd``, per launch): uv's
    backward, and dist's jet for the product rule; part's and the frozen
    nets' gradients are not needed."""
    nets = cfg["nets"]
    n_col = real_rows(banks)
    n_hole = banks["hole"]["xyt"].shape[0]
    s_col = 5   # value, three tangents, d²/dt²
    step = 0
    for rows, s in ((n_col, s_col), (n_hole, 1)):
        step += rows * (fl.value_and_grad(nets["uv"], s)
                        + fl.fwd(nets["dist"], s) + fl.fwd(nets["part"], s))
    bwd = n_col * (fl.bwd(nets["uv"], s_col) + fl.fwd(nets["dist"], s_col))
    # x read and its cotangent written, the stream cotangents read.
    bwd_bytes = n_col * 4 * (3 + 3 + s_col * nets["uv"][-1])
    return {"step": float(step), "bwd": float(bwd),
            "bwd_bytes": float(bwd_bytes)}


def serve_flops_per_point(cfg: dict) -> dict:
    """The order-1 composite forward (value and three tangents) through
    the three nets, per point answered, and its bytes (x read, the
    streams written)."""
    nets = cfg["nets"]
    flops = sum(fl.fwd(nets[k], 4) for k in ("uv", "dist", "part"))
    return {"fwd": float(flops), "fwd_bytes": float(4 * (3 + 4 * nets["uv"][-1]))}


def serve_model():
    from pinn_elastodynamics_torch.cases import plate_hole

    return plate_hole.build_model()


def serve_params(weights: dict) -> dict:
    return {k: program_tree(v) for k, v in weights.items()}
