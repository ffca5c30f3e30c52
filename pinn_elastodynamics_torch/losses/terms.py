"""Declarative loss terms and weighted loss assembly (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/losses/terms.py``.  A case declares
``(bank_name, term)`` pairs; every term contributes named mean-square
components (f_uv, f_s, HOLE, DIST, PART, ...), and a per-component weight
map assembles the scalar total, as the reference's hand-written weighted
sums do (PlateHoleQuarter/train/train.py:186-217).  The terms record each
masked mean square as a sum and a count (:class:`MaskedSums`), and the
loss divides once they are complete; over banks sharded by
``parallel/mesh.py`` one all-reduce first adds them over the ranks, so
every masked mean is a global sum over a global count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..banks import PointBank
from ..models.fields import FieldSpec
from ..ops import residuals as res_ops
from ..ops import traction as trac_ops
from ..ops.elasticity import Material
from ..parallel.mesh import mesh_of, sum_grads_over_ranks, sum_over_ranks

DT_PREFIX = "dt:"  # channel name "dt:u" = time derivative of channel u


class MaskedSums:
    """Every masked mean square of one loss evaluation as its sum of
    squares and valid-point count, in the order the terms make them; the
    loss divides once the sums are complete (and, over sharded banks,
    summed over the ranks).  ``keys`` holds (term index, component name)
    per entry; ``term`` is the index of the term being evaluated.
    ``dtype`` upcasts the square-and-sum while the residuals stay in the
    network's compute dtype; ``chunks`` (banks.ChunkSumCollector, the
    host-f64 loss of train/lbfgs_host.py) also gets each square's chunk
    sums."""

    def __init__(self, dtype=None, chunks=None):
        self.dtype = dtype
        self.chunks = chunks
        self.term = 0
        self.keys = []
        self.sums = []
        self.counts = []

    def add(self, name: str, r: torch.Tensor, mask: torch.Tensor):
        if self.chunks is not None:
            self.chunks.add(name, r, mask)
        if r.ndim > 1:
            r = r.reshape(r.shape[0])
        if self.dtype is not None:
            r = r.to(self.dtype)
            mask = mask.to(self.dtype)
        s = torch.sum(r * r * mask)
        self.keys.append((self.term, name))
        self.sums.append(s)
        self.counts.append(torch.sum(mask).to(s.dtype))

    def packed(self) -> torch.Tensor:
        """[sums; counts], one vector."""
        return torch.stack(self.sums + self.counts)


def _net_view(model, params, net: Optional[str]):
    """The full (possibly composite) model, or one of a composite's
    sub-networks ('uv' | 'dist' | 'part')."""
    if net is None:
        return model, params
    return getattr(model, f"{net}_net"), params[net]


@dataclasses.dataclass(frozen=True)
class PDEResidual:
    """Momentum + constitutive residuals on a collocation bank: components
    'f_uv' (momentum + velocity definition) and 'f_s' (constitutive)."""

    plane: str
    name_uv: str = "f_uv"
    name_s: str = "f_s"

    def evaluate(self, model, params, mat: Material, bank: PointBank,
                 sums: MaskedSums):
        spec: FieldSpec = model.spec
        jet = model.jet(params, bank.xyt)
        res = res_ops.residuals(jet, spec, mat, self.plane)
        for n in res_ops.momentum_group(spec):
            sums.add(self.name_uv, res[n], bank.mask)
        for n in res_ops.stress_group(spec):
            sums.add(self.name_s, res[n], bank.mask)


@dataclasses.dataclass(frozen=True)
class FieldTarget:
    """Mean-square mismatch of selected field channels against bank targets.

    ``channels`` lists output-channel names; the prefix ``dt:`` selects the
    time derivative of a channel.  Targets come from
    ``bank.values[target_key]`` (one column per channel) or default to zero.
    ``net`` selects a composite sub-network view.
    """

    name: str
    channels: Tuple[str, ...]
    target_key: Optional[str] = None
    net: Optional[str] = None

    def evaluate(self, model, params, mat: Material, bank: PointBank,
                 sums: MaskedSums):
        del mat
        net, net_params = _net_view(model, params, self.net)
        if any(c.startswith(DT_PREFIX) for c in self.channels):
            jet = net.jet(net_params, bank.xyt, order=1)
            fields, dt = jet.f, jet.dt
        else:
            fields, dt = net.apply(net_params, bank.xyt), None
        targets = bank.values.get(self.target_key) if self.target_key else None
        for j, ch in enumerate(self.channels):
            if ch.startswith(DT_PREFIX):
                pred = dt[:, net.spec.index(ch[len(DT_PREFIX):])]
            else:
                pred = fields[:, net.spec.index(ch)]
            if targets is not None:
                pred = pred - (targets[:, j] if targets.ndim > 1 else targets)
            sums.add(self.name, pred, bank.mask)


@dataclasses.dataclass(frozen=True)
class Traction:
    """Surface-traction residual t = sigma·n against optional targets.

    Normals come from ``bank.values['normals']`` ((N, ndim)); targets from
    ``bank.values[target_key]`` or zero (traction-free).
    """

    name: str
    target_key: Optional[str] = None
    net: Optional[str] = None

    def evaluate(self, model, params, mat: Material, bank: PointBank,
                 sums: MaskedSums):
        del mat
        net, net_params = _net_view(model, params, self.net)
        fields = net.apply(net_params, bank.xyt)
        normals = bank.values["normals"]
        if net.spec.ndim == 2:
            comps = trac_ops.traction_2d(fields, net.spec, normals[:, 0],
                                         normals[:, 1])
        else:
            comps = trac_ops.traction_3d(fields, net.spec, normals[:, 0],
                                         normals[:, 1], normals[:, 2])
        targets = bank.values.get(self.target_key) if self.target_key else None
        for j, c in enumerate(comps):
            if targets is not None:
                c = c - targets[:, j]
            sums.add(self.name, c, bank.mask)


@dataclasses.dataclass(frozen=True)
class Regression:
    """Channel-wise regression of a (sub-)network against bank targets —
    the distance-net pretraining loss."""

    name: str
    target_key: str = "targets"
    net: Optional[str] = None

    def evaluate(self, model, params, mat: Material, bank: PointBank,
                 sums: MaskedSums):
        del mat
        net, net_params = _net_view(model, params, self.net)
        pred = net.apply(net_params, bank.xyt)
        targets = bank.values[self.target_key]
        for j in range(pred.shape[1]):
            sums.add(self.name, pred[:, j] - targets[:, j], bank.mask)


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """A case's loss: (bank_name, term) pairs + per-component weights.

    Components with weight 0 are still evaluated and reported; components
    absent from ``weights`` default to 0.  ``accum_dtype`` ("float64")
    upcasts every component's square-and-mean and the weighted total while
    the jets stay in the model's compute dtype.
    """

    terms: Tuple[Tuple[str, object], ...]
    weights: Tuple[Tuple[str, float], ...]
    accum_dtype: Optional[str] = None

    def weight_map(self) -> Dict[str, float]:
        return dict(self.weights)

    def evaluate(self, model, params, mat: Material,
                 banks: Dict[str, PointBank], collector=None):
        """Returns (total_scalar, components_dict).

        ``collector`` (banks.ChunkSumCollector) also records every
        component's per-chunk partial sums, for the host-f64 loss.

        Over banks sharded by ``parallel.mesh.shard_banks`` each component
        is global on every rank: the sums and counts go through one
        all-reduce, and the gradients through one more in the backward.
        """
        mesh = mesh_of(banks[name] for name, _ in self.terms)
        if mesh is not None and collector is not None:
            raise ValueError("the chunk-sum collector takes no sharded banks")
        sums = self.masked_sums(model, sum_grads_over_ranks(params, mesh),
                                mat, banks, collector)
        comps = self.components(sums.keys, sum_over_ranks(sums.packed(), mesh))
        return self.weighted(comps), comps

    def weighted(self, comps: Dict[str, torch.Tensor]) -> torch.Tensor:
        wmap = self.weight_map()
        return sum(wmap.get(k, 0.0) * v for k, v in comps.items())

    def masked_sums(self, model, params, mat: Material,
                    banks: Dict[str, PointBank], collector=None) -> MaskedSums:
        """Every masked mean square of this loss as its sum and count on
        ``banks`` (a rank's own, for sharded banks)."""
        adt = getattr(torch, self.accum_dtype) if self.accum_dtype else None
        sums = MaskedSums(adt, collector)
        for i, (bank_name, term) in enumerate(self.terms):
            sums.term = i
            term.evaluate(model, params, mat, banks[bank_name], sums)
        return sums

    @staticmethod
    def components(keys, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The components from a packed [sums; counts] of ``keys``' entries:
        each entry's mean, summed within its term and then across terms in
        the terms' order (the JAX package's order of additions)."""
        n = len(keys)
        means = packed[:n] / torch.clamp(packed[n:], min=1.0)
        per_term: Dict[int, Dict[str, torch.Tensor]] = {}
        for (i, name), m in zip(keys, means.unbind()):
            out = per_term.setdefault(i, {})
            out[name] = out[name] + m if name in out else m
        comps: Dict[str, torch.Tensor] = {}
        for out in per_term.values():
            for k, v in out.items():
                comps[k] = comps[k] + v if k in comps else v
        return comps
