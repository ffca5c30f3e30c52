"""Plain reference of the elastic wave in the confined plate with hard BCs
and 64 Fourier features (W2).

The physics and the banks are the reference project's confined wave
(ElasticWaveConfined/ElasticWave.py:881-1026; ``wave_confined.py`` here):
plane strain, E = 2.5, ν = 0.25, ρ = 1, the first-order formulation
(outputs u, v, u_t, v_t, σ11, σ22, σ12).  Two departures from that script,
which trains one plain 3-140x6-7 net with soft IC and edge terms:

- hard BCs: u = P + D·ũ with P = 0 and a closed-form D per channel, so the
  fixed edges and the zero initial state hold by construction and the IC
  and FIX terms are left out of the loss;
- random Fourier features (Tancik et al., arXiv:2006.10739): ũ is a tanh
  MLP 128 -> 140 x 6 -> 7 of γ = [sin z, cos z], z = 2π·xn·B, with xn the
  coordinates mapped onto [-1, 1] from lb = (-15, -15, 0), ub = (15, 15,
  14) and B a fixed (3, 64) matrix.

D, with s(z) = L·tanh(z/L), L = 5, the edge envelope
env = s(x + 15)·s(15 - x)·s(y + 15)·s(15 - y) / s(15)⁴ and τ = tanh(t):

    D = (τ²·env, τ²·env, τ·env, τ·env, τ, τ, τ).

    loss = 5·f_uv + 5·f_s + SRC,

f_uv the mean squares of the momentum residuals and the velocity
definitions over the collocation rows, f_s those of the three constitutive
residuals, SRC those of (u, v) against the source's prescribed
displacement.  Every jet is written out by the chain rule: the embedding's
tangents dz_i = 2π·(2/(ub_i - lb_i))·B[i], D's by the derivatives of tanh,
the MLP's from that seed, and the composite's by the product rule.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from .mlp import Jet, as_tensor, forward, matmul, row_blocks
from .wave_confined import RHO, W_S, W_UV, _constitutive

LB = (-15.0, -15.0, 0.0)
UB = (15.0, 15.0, 14.0)
L = 5.0
HALF = 15.0   # the plate is [-15, 15]²
W_SRC = 1.0


def embed_jet(b: torch.Tensor, x: torch.Tensor, precision: str) -> Jet:
    """The embedding γ at points ``x`` (N, 3): value (N, 2F) and one
    tangent per coordinate."""
    lb = torch.tensor(LB, dtype=x.dtype, device=x.device)
    ub = torch.tensor(UB, dtype=x.dtype, device=x.device)
    scale = 2.0 / (ub - lb)
    xn = 2.0 * (x - lb) / (ub - lb) - 1.0
    z = 2.0 * math.pi * matmul(xn, b, precision)
    sin, cos = torch.sin(z), torch.cos(z)
    d = []
    for i in range(x.shape[1]):
        dz = 2.0 * math.pi * scale[i] * b[i]
        d.append(torch.cat([cos * dz, -sin * dz], dim=1))
    return Jet(torch.cat([sin, cos], dim=1), d)


def seeded_jet(net, seed: Jet, precision: str) -> Jet:
    """The order-1 jet of a tanh MLP from the input streams ``seed``."""
    h, d = seed.f, seed.d
    for w, b in net[:-1]:
        z = matmul(h, w, precision) + b
        dz = [matmul(t, w, precision) for t in d]
        y = torch.tanh(z)
        g = 1.0 - y * y
        d = [g * t for t in dz]
        h = y
    w, b = net[-1]
    return Jet(matmul(h, w, precision) + b,
               [matmul(t, w, precision) for t in d])


def _s(z):
    return L * torch.tanh(z / L)


def _ds(z):
    th = torch.tanh(z / L)
    return 1.0 - th * th


def dist_jet(x: torch.Tensor) -> Jet:
    """D and its tangents at points ``x`` (N, 3), each (N, 7)."""
    px, py, t = x[:, 0], x[:, 1], x[:, 2]
    norm = (L * math.tanh(HALF / L)) ** 4
    ax, bx, ay, by = _s(px + HALF), _s(HALF - px), _s(py + HALF), _s(HALF - py)
    env = ax * bx * ay * by / norm
    env_x = (_ds(px + HALF) * bx - ax * _ds(HALF - px)) * ay * by / norm
    env_y = ax * bx * (_ds(py + HALF) * by - ay * _ds(HALF - py)) / norm
    tau = torch.tanh(t)
    tau_t = 1.0 - tau * tau
    zero = torch.zeros_like(t)

    def channels(uv, vel, stress):
        return torch.stack([uv, uv, vel, vel, stress, stress, stress], dim=1)

    return Jet(channels(tau * tau * env, tau * env, tau),
               [channels(tau * tau * env_x, tau * env_x, zero),
                channels(tau * tau * env_y, tau * env_y, zero),
                channels(2.0 * tau * tau_t * env, tau_t * env, tau_t)])


def composite_jet(nets: dict, x: torch.Tensor, precision: str) -> Jet:
    """u = D·ũ (P = 0), each channel, as an order-1 jet."""
    uv = seeded_jet(nets["mlp"], embed_jet(nets["B"], x, precision),
                    precision)
    return dist_jet(x) * uv


def composite_forward(nets: dict, x: torch.Tensor,
                      precision: str) -> torch.Tensor:
    h = embed_jet(nets["B"], x, precision).f
    return dist_jet(x).f * forward(nets["mlp"], h, precision)


def loss_blocks(nets: dict, banks: dict, precision: str, device,
                block: int = 32768):
    """The loss as a sum of per-block scalars."""
    col = banks["collocation"]["xyt"]
    n_col = col.shape[0]
    for s, e in row_blocks(n_col, block):
        j = composite_jet(nets, as_tensor(col[s:e], precision, device),
                          precision)
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
    src = banks["src"]
    n_src = src["xyt"].shape[0]
    for s, e in row_blocks(n_src, block):
        f = composite_forward(nets, as_tensor(src["xyt"][s:e], precision,
                                              device), precision)
        r = f[:, 0:2] - as_tensor(src["uv"][s:e], precision, device)
        yield W_SRC * torch.sum(r * r) / n_src
