"""Adam training loop (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/train/adam.py``.  :class:`Adam` is
the update of ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
root, bias correction by the step count), written out so that it follows
optax's arithmetic; its state is a plain dict ``{"count", "mu", "nu"}`` that
checkpoints as numpy and resumes exactly.  Each step is one value+grad of
the loss; per-component losses come from the same evaluation.  ``run_adam``
runs the steps in segments with a host hook between them, as the JAX loop
does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
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
             iters: int, opt_state: Optional[dict] = None, log_every: int = 0,
             segment: int = 200,
             on_segment: Optional[Callable] = None) -> AdamResult:
    """Run ``iters`` Adam steps of ``loss_and_aux_fn(params) -> (loss, aux)``.

    Steps run in segments of ``segment``; each segment's losses stay on the
    device until its end (one read-back).  ``on_segment(done, params,
    opt_state, segment_history)`` runs between segments: checkpoint
    ``{params, opt_state}`` there and pass ``opt_state`` back to resume
    exactly (moments and step count carry over).  ``log_every`` prints the
    loss at segment ends.
    """
    opt = Adam(learning_rate)
    if opt_state is None:
        opt_state = opt.init(params)
    histories = []
    done = 0
    while done < iters:
        seg = min(segment, iters - done)
        rows = []
        for _ in range(seg):
            (loss, aux), grads = value_and_grad(loss_and_aux_fn, params,
                                                has_aux=True)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            rows.append({"loss": loss, **aux})
        hist = {k: torch.stack([r[k] for r in rows]).cpu().numpy()
                for k in rows[0]}
        histories.append(hist)
        done += seg
        if log_every and (done % log_every < seg or seg >= log_every):
            print(f"adam it {done}: loss {float(hist['loss'][-1]):.6g}",
                  flush=True)
        if on_segment is not None:
            on_segment(done, params, opt_state, hist)
    history = {k: np.concatenate([h[k] for h in histories])
               for k in histories[0]} if histories else {}
    return AdamResult(params, opt_state, history)
