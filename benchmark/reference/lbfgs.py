"""The L-BFGS direction, written out plainly (numpy, float64).

The update of ``optax.scale_by_lbfgs`` that the program's optimizer
follows: at the first step the gradient scaled by min(1/‖g‖, 1); after
that, the two-loop product of the inverse-Hessian estimate with the
gradient, over the pairs (s_i, y_i) = (x_{i+1} - x_i, g_{i+1} - g_i) with
weights ρ_i = 1/(s_i·y_i) (0 where s_i·y_i = 0) and the identity scaled by
γ = s·y / y·y of the newest pair (1 where y·y = 0).  The step is minus the
direction times the line search's step size.

The reference follows the program from the program's own iterates: the
points x_k are the program's, the gradients at them are the reference's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def two_loop(g: np.ndarray, pairs, gamma: float) -> np.ndarray:
    """The inverse-Hessian estimate of the ``pairs`` (s, y, ρ), oldest
    first, times ``g``, with the identity scaled by ``gamma``."""
    q = g.copy()
    alphas = []
    for s, y, rho in reversed(pairs):
        a = rho * float(s @ q)
        q -= a * y
        alphas.append(a)
    q *= gamma
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        q += (a - rho * float(y @ q)) * s
    return q


def _pair(x0, x1, g0, g1):
    s, y = x1 - x0, g1 - g0
    sy, yy = float(s @ y), float(y @ y)
    return (s, y, 0.0 if sy == 0.0 else 1.0 / sy), (sy / yy if yy > 0.0
                                                     else 1.0)


def directions(xs: Sequence[np.ndarray], gs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """The step direction u_k (minus the preconditioned gradient) at each
    iterate ``xs[k]`` with gradient ``gs[k]``, from the first step of a
    run, for a memory longer than the run."""
    out, pairs = [], []
    for k, g in enumerate(gs):
        if k == 0:
            gamma = min(1.0 / float(np.sqrt(g @ g)), 1.0)
        else:
            pair, gamma = _pair(xs[k - 1], xs[k], gs[k - 1], g)
            pairs.append(pair)
        out.append(-two_loop(g, pairs, gamma))
    return out


def last_direction(xs: Sequence[np.ndarray],
                   gs: Sequence[np.ndarray]) -> np.ndarray:
    """The direction at the newest iterate ``xs[-1]`` of a run past its
    first step, whose memory holds the pairs of the iterates ``xs`` (with
    a full memory of m pairs, the m + 1 newest iterates)."""
    pairs, gamma = [], 1.0
    for k in range(1, len(xs)):
        pair, gamma = _pair(xs[k - 1], xs[k], gs[k - 1], gs[k])
        pairs.append(pair)
    return -two_loop(gs[-1], pairs, gamma)


def change(xs: Sequence[np.ndarray], gs: Sequence[np.ndarray],
           steps: Sequence[float]) -> np.ndarray:
    """x_K - x_0 as the reference makes it: Σ_k step_k·u_k over the K
    steps whose sizes ``steps`` the line search chose."""
    us = directions(xs[:len(steps)], gs[:len(steps)])
    return sum(a * u for a, u in zip(steps, us))
