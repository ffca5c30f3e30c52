"""The elastic wave in a confined plate, soft BCs (W1): its banks from the
seed, the program's loss over them, and the work it needs.

The banks are the reference project's (ElasticWaveConfined/
ElasticWave.py:926-968) drawn by the benchmark's frozen samplers in the
order the program's ``cases/wave_confined.py::build_banks`` draws them.
The case has one phase, over every parameter.
"""

from __future__ import annotations

import numpy as np

from .. import flops as fl
from .. import samplers as smp
from ..weights import program_tree
from .plate_netbc import program_banks

SRC_R = 2.0
REFERENCE = "wave_confined"
TRAINABLE = "net"


def banks(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    scale, max_t = cfg["scale"], cfg["max_t"]
    s = lambda n: max(8, int(round(n * scale)))
    lb, ub = (-15.0, -15.0, 0.0), (15.0, 15.0, max_t)
    ic = smp.edge_lhs(lb, (30.0, 30.0, 0.0), s(6000), rng)
    ic = smp.exclude_disk(ic, xc=0.0, yc=0.0, r=SRC_R)
    fixed = np.concatenate([
        smp.edge_lhs((-15.0, -15.0, 0.0), (0.0, 30.0, max_t), s(7000), rng),
        smp.edge_lhs((15.0, -15.0, 0.0), (0.0, 30.0, max_t), s(7000), rng),
        smp.edge_lhs((-15.0, -15.0, 0.0), (30.0, 0.0, max_t), s(7000), rng),
        smp.edge_lhs((-15.0, 15.0, 0.0), (30.0, 0.0, max_t), s(7000), rng),
    ])
    near_b = smp.lhs_box(lb, ub, s(50000), rng)
    near_b = near_b[(np.abs(near_b[:, 0]) > 12) | (np.abs(near_b[:, 1]) > 12)]
    col = np.concatenate([
        smp.lhs_box(lb, ub, s(120000), rng),
        smp.edge_lhs((-SRC_R - 1, -SRC_R - 1, 0.0),
                     (2 * (SRC_R + 1), 2 * (SRC_R + 1), max_t), s(15000), rng),
        near_b])
    col = smp.exclude_disk(col, xc=0.0, yc=0.0, r=SRC_R)
    tt = np.concatenate([np.linspace(0, 4, s(141)),
                         np.linspace(4, max_t, s(141))])[1:]
    src = smp.cross_time(
        smp.circle_points(xc=0.0, yc=0.0, r=SRC_R, n=s(200)), tt)
    src_uv = smp.radial_displacement(src[:, 0:2],
                                     smp.gaussian_pulse(src[:, 2:3]),
                                     xc=0.0, yc=0.0, r=SRC_R)
    return {"collocation": {"xyt": col}, "src": {"xyt": src, "uv": src_uv},
            "ic": {"xyt": ic}, "fixed": {"xyt": fixed}}


def program(cfg: dict, banks: dict, weights: dict, device, fault=None):
    """(sub_fn, sub0): the program's one phase, over every parameter."""
    from pinn_elastodynamics_torch.cases import wave_confined
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn

    case = wave_confined.build(scale=1e-3, max_t=cfg["max_t"], device=device)
    case.banks = program_banks(cfg, banks, device, fault)
    phase = case.phases[-1]
    if phase.trainable is not None:
        raise RuntimeError(f"W1's phase trains {phase.trainable!r}")
    sub_fn, sub0, _ = _phase_loss_fn(case, phase,
                                     program_tree(weights[TRAINABLE]))
    return sub_fn, sub0


def reference_nets(weights: dict, trainable, precision: str, device) -> dict:
    return {TRAINABLE: trainable}


def real_rows(banks: dict) -> int:
    return banks["collocation"]["xyt"].shape[0]


def train_flops(cfg: dict, banks: dict) -> dict:
    """Operations of one value+grad of the loss (``step``): the order-1
    jet (value and three tangents) on the collocation rows, the plain
    forward on the source, IC and edge rows; and of the backward stage B2
    per launch (``bwd``: the collocation rows' backward)."""
    dims = cfg["nets"][TRAINABLE]
    n_col = real_rows(banks)
    other = sum(banks[k]["xyt"].shape[0] for k in ("src", "ic", "fixed"))
    step = (n_col * fl.value_and_grad(dims, 4)
            + other * fl.value_and_grad(dims, 1))
    # the seed streams read, their value rows' cotangent written, the
    # stream cotangents read.
    bwd_bytes = n_col * 4 * (4 * 3 + 3 + 4 * dims[-1])
    return {"step": float(step), "bwd": float(n_col * fl.bwd(dims, 4)),
            "bwd_bytes": float(bwd_bytes)}
