"""Plain reference of the net-BC quarter plate with a hole.

The main-phase loss of the reference project (PlateHoleQuarter/train/
train.py:186-217, 404-461): plane stress, E = 20, ν = 0.25, ρ = 1, the
second-order formulation (outputs u, v, σ11, σ22, σ12), the hard-BC
composite ``part + dist·uv`` of three tanh MLPs, and

    loss = 10·(f_uv + f_s + HOLE),

with f_uv the mean squares of the two momentum residuals over the
collocation rows, f_s those of the three constitutive residuals, and HOLE
those of the two traction components σ·n on the hole's surface.  Also the
fields a client of the trained model is served: the five outputs, the
engineering strains and the displacement amplitude, at time t.
"""

from __future__ import annotations

import numpy as np
import torch

from .mlp import as_tensor, composite_forward, composite_jet, row_blocks

E, NU, RHO = 20.0, 0.25, 1.0
W_UV = W_S = W_HOLE = 10.0


def _constitutive(e11, e22, e12):
    c = E / (1.0 - NU * NU)
    g = E / (2.0 * (1.0 + NU))
    return c * e11 + c * NU * e22, c * NU * e11 + c * e22, g * e12


def loss_blocks(nets: dict, banks: dict, precision: str, device,
                block: int = 32768):
    """The loss as a sum of per-block scalars (so that a caller may take
    the gradient block by block)."""
    col = banks["collocation"]["xyt"]
    n_col = col.shape[0]
    for s, e in row_blocks(n_col, block):
        x = as_tensor(col[s:e], precision, device)
        j = composite_jet(nets, x, 2, precision)
        dx, dy = j.d[0], j.d[1]
        sp11, sp22, sp12 = _constitutive(dx[:, 0], dy[:, 1],
                                         dy[:, 0] + dx[:, 1])
        f_s = (j.f[:, 2] - sp11, j.f[:, 3] - sp22, j.f[:, 4] - sp12)
        f_u = dx[:, 2] + dy[:, 4] - RHO * j.tt[:, 0]
        f_v = dy[:, 3] + dx[:, 4] - RHO * j.tt[:, 1]
        yield (W_UV * (torch.sum(f_u * f_u) + torch.sum(f_v * f_v))
               + W_S * sum(torch.sum(r * r) for r in f_s)) / n_col
    hole = banks["hole"]
    n_hole = hole["xyt"].shape[0]
    for s, e in row_blocks(n_hole, block):
        x = as_tensor(hole["xyt"][s:e], precision, device)
        nrm = as_tensor(hole["normals"][s:e], precision, device)
        f = composite_forward(nets, x, precision)
        tx = f[:, 2] * nrm[:, 0] + f[:, 4] * nrm[:, 1]
        ty = f[:, 4] * nrm[:, 0] + f[:, 3] * nrm[:, 1]
        yield W_HOLE * (torch.sum(tx * tx) + torch.sum(ty * ty)) / n_hole


FIELDS = ("u", "v", "s11", "s22", "s12", "e11", "e22", "e12", "amp")


@torch.no_grad()
def fields(nets: dict, xyt: np.ndarray, precision: str, device,
           block: int = 65536) -> dict:
    """Every served field at the rows of ``xyt`` (x, y, t), as float64
    numpy arrays."""
    parts = {k: [] for k in FIELDS}
    for s, e in row_blocks(xyt.shape[0], block):
        x = as_tensor(xyt[s:e], precision, device)
        j = composite_jet(nets, x, 1, precision)
        dx, dy = j.d[0], j.d[1]
        out = {"u": j.f[:, 0], "v": j.f[:, 1], "s11": j.f[:, 2],
               "s22": j.f[:, 3], "s12": j.f[:, 4], "e11": dx[:, 0],
               "e22": dy[:, 1], "e12": dy[:, 0] + dx[:, 1]}
        out["amp"] = torch.sqrt(out["u"] ** 2 + out["v"] ** 2)
        for k in FIELDS:
            parts[k].append(out[k].double().cpu().numpy())
    return {k: np.concatenate(v) for k, v in parts.items()}
