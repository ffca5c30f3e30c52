"""Data parallelism over the points axis (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/parallel/mesh.py``.  Point banks
are split along their batch axis across the ranks of a process group, and
parameters are replicated.  In JAX, GSPMD inserts the all-reduces behind
the masked means and the gradients; here they are written out:

- every masked mean of a loss over sharded banks is a global sum over a
  global count.  ``LossSpec.evaluate`` packs each mean's local sum and
  valid count into one vector and sums it over the ranks once per
  evaluation (:func:`sum_over_ranks`), before it divides;
- the gradient is summed over the ranks once per backward: the parameter
  leaves pass through an identity whose backward all-reduces every leaf's
  gradient in one flat buffer (:func:`sum_grads_over_ranks`).

So ``make_loss_fn``, ``make_grad_step``, ``value_and_grad``, ``minimize``
and ``run_adam`` run unchanged on banks from :func:`shard_banks`, and every
rank holds the same loss, gradient and parameters bit for bit.  With no
process group the mesh has one rank, its reductions are the identity, and
the same code runs on one device.

``bank_sharding`` and ``replicated`` of the JAX module return placements
that GSPMD obeys; they have no counterpart here, where the slice a rank
keeps is the placement.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from ..banks import PointBank
from ..device import resolve_device
from ..utils.tree import tree_leaves, tree_map

POINTS_AXIS = "points"

# Collectives made, by kind: "sums" (a loss's packed sums and counts, in the
# forward), "grads" (the packed gradient, in the backward) and "gathers"
# (a sharded bank's per-row values joined on every rank, in
# ``geometry.adaptive.topk_refine``).
COLLECTIVES = {"sums": 0, "grads": 0, "gathers": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the ranks of ``group`` along ``axis_name``.

    ``group`` is None for a mesh of one rank without a process group.
    ``device`` is where this rank keeps its shards and parameters.
    """

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis_name: str = POINTS_AXIS


def make_mesh(group=None, device=None, axis_name: str = POINTS_AXIS) -> Mesh:
    """The mesh over ``group`` (default: the initialised default group).

    With no process group it is a mesh of one rank on ``device`` (default
    ``cuda``).  Under a group the device defaults to ``cuda:{LOCAL_RANK}``;
    the CPU is taken only when asked for, and only with gloo (NCCL reduces
    CUDA tensors only).
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, resolve_device(device or "cuda"), axis_name)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    if dev.type != "cuda" and dist.get_backend(group) == "nccl":
        raise ValueError(f"device {dev} under an NCCL group: NCCL reduces "
                         "CUDA tensors only; use gloo for the CPU")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev,
                axis_name)


def shard_bank(bank: PointBank, mesh: Mesh) -> PointBank:
    """This rank's contiguous rows ``[rank·n/size, (rank+1)·n/size)`` of
    every array of ``bank``, copied to ``mesh.device`` and marked as sharded
    over ``mesh`` (so the losses reduce over the ranks).

    The bank must be padded to a multiple of the mesh size (see
    ``banks.make_bank(pad_to_multiple_of=...)``); masked means make padding
    loss-neutral.
    """
    n = bank.n_total
    if n % mesh.size:
        raise ValueError(
            f"bank size {n} not divisible by mesh size {mesh.size}; "
            "pad with make_bank(pad_to_multiple_of=mesh_size)"
        )
    rows = n // mesh.size

    def put(a):
        return a.narrow(0, mesh.rank * rows, rows).to(mesh.device, copy=True)

    return PointBank(xyt=put(bank.xyt), mask=put(bank.mask),
                     values={k: put(v) for k, v in bank.values.items()},
                     mesh=mesh)


def shard_banks(banks: Dict[str, PointBank],
                mesh: Mesh) -> Dict[str, PointBank]:
    return {k: shard_bank(b, mesh) for k, b in banks.items()}


def replicate(tree, mesh: Mesh):
    """``tree`` (parameters, the Adam state ``{"count", "mu", "nu"}``) on
    ``mesh.device``, with every leaf broadcast from the mesh's rank 0, so
    that all ranks start from the same bits."""
    if mesh.group is None:
        return tree_map(lambda x: x.detach().to(mesh.device, copy=True)
                        if torch.is_tensor(x) else x, tree)
    src = dist.get_global_rank(mesh.group, 0)

    def put(x):
        if not torch.is_tensor(x):
            box = [x]
            dist.broadcast_object_list(box, src=src, group=mesh.group,
                                       device=mesh.device)
            return box[0]
        t = x.detach().to(mesh.device, copy=True)
        dist.broadcast(t, src=src, group=mesh.group)
        return t

    return tree_map(put, tree)


def mesh_of(banks: Iterable[PointBank]) -> Optional[Mesh]:
    """The mesh the banks are sharded over, or None for unsharded banks;
    raises if they mix meshes or sharded and unsharded banks."""
    meshes = {id(b.mesh): b.mesh for b in banks}
    if len(meshes) > 1:
        raise ValueError("banks sharded over different meshes (or some not "
                         "sharded): shard every bank of a loss with one mesh")
    return next(iter(meshes.values()), None)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) in the forward; the backward passes the cotangent
    through unchanged, since each rank's loss depends on every rank's
    local sums through the same global sum."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        COLLECTIVES["sums"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the mesh's ranks (one all-reduce), differentiable;
    ``x`` itself with no mesh or no process group."""
    if mesh is None or mesh.group is None:
        return x
    return _SumOverRanks.apply(x, mesh.group)


def gather_over_ranks(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along the
    first axis in rank order: for a sharded bank's per-row values, the
    whole bank's, since the shards are contiguous in rank order (one
    all-gather, not differentiable).  ``x`` itself with no mesh or no
    process group."""
    if mesh is None or mesh.group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    COLLECTIVES["gathers"] += 1
    return torch.cat(parts)


class _SumGrads(torch.autograd.Function):
    """Identity in the forward; the backward packs every leaf's gradient
    into one flat buffer, all-reduces it (sum) and splits it again."""

    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group = group
        ctx.shapes = [t.shape for t in leaves]
        ctx.dtypes = [t.dtype for t in leaves]
        return leaves

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])   # promotes dtypes
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        COLLECTIVES["grads"] += 1
        parts = torch.split(flat, [s.numel() for s in ctx.shapes])
        return (None, *(p.view(s).to(dt) for p, s, dt
                        in zip(parts, ctx.shapes, ctx.dtypes)))


def sum_grads_over_ranks(params, mesh: Optional[Mesh]):
    """``params`` with every leaf that requires a gradient passed through
    one identity whose backward sums the leaves' gradients over the ranks
    (one all-reduce per backward).  Unchanged with no mesh, no process
    group or no such leaf.  A leaf that already passed through it raises:
    its gradient would be summed twice."""
    if mesh is None or mesh.group is None or not torch.is_grad_enabled():
        return params
    leaves = tree_leaves(params)
    live = [i for i, t in enumerate(leaves) if t.requires_grad]
    if not live:
        return params
    if any(isinstance(leaves[i].grad_fn, _SumGrads._backward_cls)
           for i in live):
        raise ValueError("parameters already summed over the ranks: their "
                         "gradients would be summed twice")
    out = list(leaves)
    for i, t in zip(live, _SumGrads.apply(mesh.group,
                                          *(leaves[i] for i in live))):
        out[i] = t
    it = iter(out)
    return tree_map(lambda _: next(it), params)
