"""Plain reference of the elastic wave in the confined plate, soft BCs.

The loss of the reference project (ElasticWaveConfined/ElasticWave.py:
139-156, 304-348): plane strain, E = 2.5, ν = 0.25, ρ = 1, the first-order
formulation (outputs u, v, u_t, v_t, σ11, σ22, σ12) of one tanh MLP, and

    loss = 5·f_uv + 5·f_s + SRC + IC + FIX,

with f_uv the mean squares of the momentum residuals (σ_ij,j - ρ·∂u_t/∂t)
and the velocity definitions (∂u/∂t - u_t) over the collocation rows, f_s
those of the three constitutive residuals, SRC the mean squares of (u, v)
against the source's prescribed displacement, IC those of u, v, u_t, v_t
at t = 0 and FIX those of u, v on the four fixed edges.
"""

from __future__ import annotations

import torch

from .mlp import as_tensor, forward, jet, row_blocks

E, NU, RHO = 2.5, 0.25, 1.0
W_UV = W_S = 5.0


def _constitutive(e11, e22, e12):
    c = E / ((1.0 + NU) * (1.0 - 2.0 * NU))
    g = E / (2.0 * (1.0 + NU))
    return (c * (1.0 - NU) * e11 + c * NU * e22,
            c * NU * e11 + c * (1.0 - NU) * e22, g * e12)


def loss_blocks(nets: dict, banks: dict, precision: str, device,
                block: int = 32768):
    """The loss as a sum of per-block scalars."""
    net = nets["net"]
    col = banks["collocation"]["xyt"]
    n_col = col.shape[0]
    for s, e in row_blocks(n_col, block):
        x = as_tensor(col[s:e], precision, device)
        j = jet(net, x, 1, precision)
        dx, dy, dt = j.d
        sp11, sp22, sp12 = _constitutive(dx[:, 0], dy[:, 1],
                                         dy[:, 0] + dx[:, 1])
        f_s = (j.f[:, 4] - sp11, j.f[:, 5] - sp22, j.f[:, 6] - sp12)
        f_uv = (dx[:, 4] + dy[:, 6] - RHO * dt[:, 2],
                dy[:, 5] + dx[:, 6] - RHO * dt[:, 3],
                dt[:, 0] - j.f[:, 2],
                dt[:, 1] - j.f[:, 3])
        yield (W_UV * sum(torch.sum(r * r) for r in f_uv)
               + W_S * sum(torch.sum(r * r) for r in f_s)) / n_col
    # (bank, channels, target key): SRC, IC and FIX, weight 1 each.
    for name, channels, key in (("src", (0, 1), "uv"),
                                ("ic", (0, 1, 2, 3), None),
                                ("fixed", (0, 1), None)):
        bank = banks[name]
        n = bank["xyt"].shape[0]
        for s, e in row_blocks(n, block):
            f = forward(net, as_tensor(bank["xyt"][s:e], precision, device),
                        precision)
            target = (as_tensor(bank[key][s:e], precision, device)
                      if key else None)
            total = 0.0
            for j, c in enumerate(channels):
                r = f[:, c] - target[:, j] if key else f[:, c]
                total = total + torch.sum(r * r)
            yield total / n
