"""Adam training loop (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/train/adam.py``.  :class:`Adam` is
the update of ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
root, bias correction by the step count), written out so that it follows
optax's arithmetic; its state is a plain dict ``{"count", "mu", "nu"}`` that
checkpoints as numpy and resumes exactly.  Each step is one value+grad of
the loss; per-component losses come from the same evaluation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.tree import tree_map
from .step import apply_updates, value_and_grad


B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


class Adam:
    """``optax.adam(learning_rate)`` as init/update."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params) -> dict:
        zeros = lambda t: torch.zeros_like(t)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(self, grads, state: dict, params=None):
        del params
        mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - B2) * (g * g) + B2 * v, grads,
                      state["nu"])
        count = state["count"] + 1
        c1, c2 = 1 - B1 ** count, 1 - B2 ** count
        step = -self.learning_rate

        def upd(m, v):
            return step * ((m / c1) / (torch.sqrt(v / c2) + EPS))

        return tree_map(upd, mu, nu), {"count": count, "mu": mu, "nu": nu}


class AdamResult(NamedTuple):
    params: object
    opt_state: dict
    history: dict  # each entry (iters,) — total + per-component losses


def run_adam(loss_and_aux_fn: Callable, params, learning_rate: float, *,
             iters: int, opt_state: Optional[dict] = None) -> AdamResult:
    """Run ``iters`` Adam steps of ``loss_and_aux_fn(params) -> (loss, aux)``.

    The losses stay on the device until the end (one read-back).  Pass the
    returned ``opt_state`` back to resume: moments and step count carry
    over.  The JAX loop's segments, logging and segment hook are not ported
    yet.
    """
    opt = Adam(learning_rate)
    if opt_state is None:
        opt_state = opt.init(params)
    rows = []
    for _ in range(iters):
        (loss, aux), grads = value_and_grad(loss_and_aux_fn, params,
                                            has_aux=True)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        rows.append({"loss": loss, **aux})
    history = {k: torch.stack([r[k] for r in rows]).cpu().numpy()
               for k in rows[0]} if rows else {}
    return AdamResult(params, opt_state, history)
