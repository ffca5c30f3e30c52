"""Plain reference of E1, the 3D elastic wave.

Rao, Sun and Liu's mixed-variable formulation (arXiv:2006.08472;
ElasticWaveConfined/ElasticWave.py:139-156, 304-348) lifted to three
dimensions: isotropic, E = 2.5, ν = 0.25, ρ = 1, one tanh MLP of the
inputs normalised to [-1, 1] (lb (-15, -15, -15, 0), ub (15, 15, 15, 10)),
with outputs (u, v, w, u_t, v_t, w_t, σ11, σ22, σ33, σ12, σ13, σ23), and

    loss = 5·f_uv + 5·f_s + SRC + IC,

f_uv the mean squares of the three momentum residuals
(σ_ij,j - ρ·∂(u_i)_t/∂t) and the three velocity definitions (∂u_i/∂t -
(u_i)_t) over the collocation rows, f_s those of the six constitutive
residuals (σ_ij - λ·tr(ε)·δ_ij - 2G·ε_ij, with the engineering shear
strains γ_ij = u_i,j + u_j,i and σ_ij = G·γ_ij off the diagonal), SRC the
mean squares of (u, v, w) against the source's prescribed displacement and
IC those of u, v, w, u_t, v_t, w_t at t = 0.

Departures from Rao et al., whose scripts are 2D: the third dimension
(w, w_t and three more stresses); the source, a radial Gaussian pulse on
the r = 2 sphere (the 3D analogue of their circle); no fixed or traction
boundary, so no FIX term.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

from .mlp import Jet, as_tensor, forward, jet, row_blocks

E, NU, RHO = 2.5, 0.25, 1.0
W_UV = W_S = 5.0
LB = (-15.0, -15.0, -15.0, 0.0)
UB = (15.0, 15.0, 15.0, 10.0)
LAMBDA = E * NU / ((1.0 + NU) * (1.0 - 2.0 * NU))
G = E / (2.0 * (1.0 + NU))
# output channels
U, V, W, UT, VT, WT, S11, S22, S33, S12, S13, S23 = range(12)


def normalise(x: torch.Tensor) -> torch.Tensor:
    lb = torch.tensor(LB, dtype=x.dtype, device=x.device)
    ub = torch.tensor(UB, dtype=x.dtype, device=x.device)
    return 2.0 * (x - lb) / (ub - lb) - 1.0


def field_jet(net, x: torch.Tensor, precision: str) -> Jet:
    """The order-1 jet of the net at raw points ``x`` (N, 4): the jet of
    the normalised inputs, tangent i times d(normalised x_i)/dx_i."""
    j = jet(net, normalise(x), 1, precision)
    scale = [2.0 / (ub - lb) for lb, ub in zip(LB, UB)]
    return Jet(j.f, [d * s for d, s in zip(j.d, scale)])


def residuals(j: Jet):
    """(f_uv, f_s) of a jet in raw coordinates: the three momentum
    residuals and the three velocity definitions; the six constitutive
    residuals."""
    f = j.f
    dx, dy, dz, dt = j.d
    e11, e22, e33 = dx[:, U], dy[:, V], dz[:, W]
    e12 = dy[:, U] + dx[:, V]
    e13 = dz[:, U] + dx[:, W]
    e23 = dz[:, V] + dy[:, W]
    tr = e11 + e22 + e33
    stress = (LAMBDA * tr + 2.0 * G * e11, LAMBDA * tr + 2.0 * G * e22,
              LAMBDA * tr + 2.0 * G * e33, G * e12, G * e13, G * e23)
    f_s = tuple(f[:, c] - sp for c, sp in
                zip((S11, S22, S33, S12, S13, S23), stress))
    f_uv = (dx[:, S11] + dy[:, S12] + dz[:, S13] - RHO * dt[:, UT],
            dx[:, S12] + dy[:, S22] + dz[:, S23] - RHO * dt[:, VT],
            dx[:, S13] + dy[:, S23] + dz[:, S33] - RHO * dt[:, WT],
            dt[:, U] - f[:, UT],
            dt[:, V] - f[:, VT],
            dt[:, W] - f[:, WT])
    return f_uv, f_s


def loss_blocks(nets: dict, banks: dict, precision: str, device,
                block: int = 32768):
    """The loss as a sum of per-block scalars."""
    net = nets["net"]
    col = banks["collocation"]["xyt"]
    n_col = col.shape[0]
    for s, e in row_blocks(n_col, block):
        f_uv, f_s = residuals(field_jet(
            net, as_tensor(col[s:e], precision, device), precision))
        yield (W_UV * sum(torch.sum(r * r) for r in f_uv)
               + W_S * sum(torch.sum(r * r) for r in f_s)) / n_col
    # (bank, channels, target key): SRC and IC, weight 1 each.
    for name, channels, key in (("src", (U, V, W), "uvw"),
                                ("ic", (U, V, W, UT, VT, WT), None)):
        bank = banks[name]
        n = bank["xyt"].shape[0]
        for s, e in row_blocks(n, block):
            x = normalise(as_tensor(bank["xyt"][s:e], precision, device))
            f = forward(net, x, precision)
            target = (as_tensor(bank[key][s:e], precision, device)
                      if key else None)
            total = 0.0
            for j, c in enumerate(channels):
                r = f[:, c] - target[:, j] if key else f[:, c]
                total = total + torch.sum(r * r)
            yield total / n
