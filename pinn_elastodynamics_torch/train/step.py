"""Value+grad and the training step (PyTorch).

Counterpart of ``make_loss_fn`` and ``make_grad_step`` in
``pinn_elastodynamics_tpu/train/step.py``: one step is value+grad over every
point bank, the optimizer update, and the per-component losses; and
``make_microbatched_loss_fn``, the collocation bank in sequential chunks
whose activations the backward recomputes (gradient accumulation for 1M+
point banks).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..banks import PointBank
from ..losses.terms import LossSpec
from ..ops.elasticity import Material
from ..parallel.mesh import mesh_of, sum_grads_over_ranks, sum_over_ranks
from ..utils.profiling import span
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
    ``jax.value_and_grad``.  Values come back detached.  Spans: ``vg``
    (the call, not synchronised with the device), ``vg.forward`` (``fn``)
    and ``vg.backward`` (the gradient)."""
    with span("vg"):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        with span("vg.forward"):
            out = fn(live)
        loss, aux = out if has_aux else (out, None)
        with span("vg.backward"):
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


def make_microbatched_loss_fn(
    model,
    spec: LossSpec,
    material: Material,
    *,
    collocation_key: str = "collocation",
    num_microbatches: int = 1,
) -> Callable:
    """Loss with the collocation bank processed in ``num_microbatches``
    sequential chunks — gradient accumulation for 1M+ point banks
    (BASELINE.json config #3) without keeping every chunk's activations.

    Each chunk runs under ``torch.utils.checkpoint`` (non-reentrant), so the
    backward recomputes a chunk's forward instead of storing it; this takes
    the place of ``jax.checkpoint`` inside ``lax.scan`` in the JAX package,
    and a Python loop over contiguous slices takes the place of the scan.
    Each chunk gives the local sum of squares and valid count of every
    collocation mean square; they add up over the chunks, so each mean is
    the full bank's sum over its count.  Non-collocation terms are
    evaluated once, full batch.  Over banks sharded by
    ``parallel.mesh.shard_banks`` the chunks split the rank's own shard,
    and the sums and counts of both parts go through one all-reduce before
    the means are formed.
    """
    col_terms = tuple(t for t in spec.terms if t[0] == collocation_key)
    other_terms = tuple(t for t in spec.terms if t[0] != collocation_key)
    col_spec = LossSpec(terms=col_terms, weights=spec.weights)
    other_spec = LossSpec(terms=other_terms, weights=spec.weights)

    def loss_fn(params, banks: Dict[str, PointBank]):
        bank = banks[collocation_key]
        n = bank.n_total
        if n % num_microbatches:
            raise ValueError(
                f"collocation bank size {n} not divisible by "
                f"{num_microbatches} microbatches"
            )
        chunk = n // num_microbatches
        mesh = mesh_of(banks[name] for name, _ in spec.terms)
        params = sum_grads_over_ranks(params, mesh)
        col_keys = []

        def chunk_sums(params, i):
            # narrow on dim 0 keeps each slice contiguous, as the kernels
            # require.
            sl = lambda a: a.narrow(0, i * chunk, chunk)
            sub = PointBank(xyt=sl(bank.xyt), mask=sl(bank.mask),
                            values={k: sl(v) for k, v in bank.values.items()})
            sums = col_spec.masked_sums(model, params, material,
                                        {collocation_key: sub})
            col_keys[:] = sums.keys
            return sums.packed()

        col = checkpoint(chunk_sums, params, 0, use_reentrant=False)
        for i in range(1, num_microbatches):
            col = col + checkpoint(chunk_sums, params, i,
                                   use_reentrant=False)
        other = other_spec.masked_sums(model, params, material, banks)
        parts = [col, other.packed()] if other.keys else [col]
        packed = sum_over_ranks(torch.cat(parts), mesh)
        n_col = 2 * len(col_keys)
        comps = col_spec.components(col_keys, packed[:n_col])
        comps_other = other_spec.components(other.keys, packed[n_col:])
        comps_all = {**comps_other, **comps}
        return spec.weighted(comps_all), comps_all

    return loss_fn
