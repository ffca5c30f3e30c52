"""Value+grad and the training step (PyTorch).

Counterpart of ``make_loss_fn`` and ``make_grad_step`` in
``pinn_elastodynamics_tpu/train/step.py``: one step is value+grad over every
point bank, the optimizer update, and the per-component losses.  The
microbatched loss is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..banks import PointBank
from ..losses.terms import LossSpec
from ..ops.elasticity import Material
from ..utils.tree import tree_leaves, tree_map


def make_loss_fn(model, spec: LossSpec, material: Material) -> Callable:
    """loss(params, banks) -> (total, components)."""

    def loss_fn(params, banks: Dict[str, PointBank]):
        return spec.evaluate(model, params, material, banks)

    return loss_fn


def value_and_grad(fn: Callable, params, *, has_aux: bool = False):
    """(value, grads) of a scalar ``fn(params)``, or ((value, aux), grads)
    with ``has_aux``; grads has the layout of ``params``, and a leaf that
    ``fn`` does not reach gets zeros of its shape and dtype, as in
    ``jax.value_and_grad``.  Values come back detached."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    out = fn(live)
    loss, aux = out if has_aux else (out, None)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True,
                                     materialize_grads=True))
    gtree = tree_map(lambda t: next(grads), live)
    loss = loss.detach()
    if not has_aux:
        return loss, gtree
    return (loss, tree_map(lambda t: t.detach(), aux)), gtree


def apply_updates(params, updates):
    """params + updates, in each parameter's dtype (``optax.apply_updates``)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_grad_step(model, spec: LossSpec, material: Material,
                   optimizer) -> Callable:
    """(params, opt_state, banks) -> (params, opt_state, loss, comps).

    ``optimizer`` has ``init(params)`` and ``update(grads, state, params)
    -> (updates, state)``, as an optax transformation (train/adam.py::Adam).
    """
    loss_fn = make_loss_fn(model, spec, material)

    def step(params, opt_state, banks):
        (loss, comps), grads = value_and_grad(
            lambda p: loss_fn(p, banks), params, has_aux=True)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, comps

    return step
