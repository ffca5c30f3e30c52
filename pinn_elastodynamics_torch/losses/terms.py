"""Declarative loss terms and weighted loss assembly (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/losses/terms.py``.  A case declares
``(bank_name, term)`` pairs; every term contributes named mean-square
components (f_uv, f_s, HOLE, DIST, PART, ...), and a per-component weight
map assembles the scalar total, as the reference's hand-written weighted
sums do (PlateHoleQuarter/train/train.py:186-217).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..banks import PointBank, masked_mean_square
from ..models.fields import FieldSpec
from ..ops import residuals as res_ops
from ..ops import traction as trac_ops
from ..ops.elasticity import Material

DT_PREFIX = "dt:"  # channel name "dt:u" = time derivative of channel u


def _mms(r, mask, dtype, collector, name):
    """masked_mean_square, and the chunk sums of the same square into
    ``collector`` when one is given (banks.ChunkSumCollector, the host-f64
    loss of train/lbfgs_host.py)."""
    if collector is not None:
        collector.add(name, r, mask)
    return masked_mean_square(r, mask, dtype)


def _net_view(model, params, net: Optional[str]):
    """The full (possibly composite) model, or one of a composite's
    sub-networks ('uv' | 'dist' | 'part')."""
    if net is None:
        return model, params
    return getattr(model, f"{net}_net"), params[net]


def _zero(like: torch.Tensor, accum_dtype) -> torch.Tensor:
    return torch.zeros((), dtype=accum_dtype or like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class PDEResidual:
    """Momentum + constitutive residuals on a collocation bank: components
    'f_uv' (momentum + velocity definition) and 'f_s' (constitutive)."""

    plane: str
    name_uv: str = "f_uv"
    name_s: str = "f_s"

    def evaluate(self, model, params, mat: Material, bank: PointBank,
                 accum_dtype=None, collector=None):
        spec: FieldSpec = model.spec
        jet = model.jet(params, bank.xyt)
        res = res_ops.residuals(jet, spec, mat, self.plane)
        return {
            self.name_uv: sum(_mms(res[n], bank.mask, accum_dtype, collector,
                                   self.name_uv)
                              for n in res_ops.momentum_group(spec)),
            self.name_s: sum(_mms(res[n], bank.mask, accum_dtype, collector,
                                  self.name_s)
                             for n in res_ops.stress_group(spec)),
        }


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
                 accum_dtype=None, collector=None):
        del mat
        net, net_params = _net_view(model, params, self.net)
        if any(c.startswith(DT_PREFIX) for c in self.channels):
            jet = net.jet(net_params, bank.xyt, order=1)
            fields, dt = jet.f, jet.dt
        else:
            fields, dt = net.apply(net_params, bank.xyt), None
        targets = bank.values.get(self.target_key) if self.target_key else None
        total = _zero(fields, accum_dtype)
        for j, ch in enumerate(self.channels):
            if ch.startswith(DT_PREFIX):
                pred = dt[:, net.spec.index(ch[len(DT_PREFIX):])]
            else:
                pred = fields[:, net.spec.index(ch)]
            if targets is not None:
                pred = pred - (targets[:, j] if targets.ndim > 1 else targets)
            total = total + _mms(pred, bank.mask, accum_dtype, collector,
                                 self.name)
        return {self.name: total}


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
                 accum_dtype=None, collector=None):
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
        total = _zero(fields, accum_dtype)
        for j, c in enumerate(comps):
            if targets is not None:
                c = c - targets[:, j]
            total = total + _mms(c, bank.mask, accum_dtype, collector,
                                 self.name)
        return {self.name: total}


@dataclasses.dataclass(frozen=True)
class Regression:
    """Channel-wise regression of a (sub-)network against bank targets —
    the distance-net pretraining loss."""

    name: str
    target_key: str = "targets"
    net: Optional[str] = None

    def evaluate(self, model, params, mat: Material, bank: PointBank,
                 accum_dtype=None, collector=None):
        del mat
        net, net_params = _net_view(model, params, self.net)
        pred = net.apply(net_params, bank.xyt)
        targets = bank.values[self.target_key]
        total = _zero(pred, accum_dtype)
        for j in range(pred.shape[1]):
            total = total + _mms(pred[:, j] - targets[:, j], bank.mask,
                                 accum_dtype, collector, self.name)
        return {self.name: total}


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
        """
        adt = getattr(torch, self.accum_dtype) if self.accum_dtype else None
        comps: Dict[str, torch.Tensor] = {}
        for bank_name, term in self.terms:
            out = term.evaluate(model, params, mat, banks[bank_name],
                                accum_dtype=adt, collector=collector)
            for k, v in out.items():
                comps[k] = comps[k] + v if k in comps else v
        wmap = self.weight_map()
        total = sum(wmap.get(k, 0.0) * v for k, v in comps.items())
        return total, comps
