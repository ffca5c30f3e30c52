"""Exact hard-BC composite: u = P(x) + D(x)·ũ(x) with closed-form P and D.

Counterpart of ``pinn_elastodynamics_tpu/models/analytic_bc.py``.  The
distance factor D and particular field P are smooth closed-form functions
(per-case definitions live with their cases, e.g.
cases/plate_hole.py::analytic_dist/analytic_part); their jets come from
forward-mode AD (ops/jet.py::jet_of_fn) and only ũ ('uv') is a network.
The factors' jets and values open the span ``model.factors`` (``rows``;
``order``, 0 for the plain forward).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import vmap

from ..ops.jet import Jet, jet_of_fn
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AnalyticCompositeFieldModel:
    """u = P + D·ũ with closed-form D and P; only ũ ('uv') has parameters.

    ``dist_fn`` / ``part_fn`` map a single coordinate vector (A,) to the
    (C,) per-channel distance factor / particular values and must be smooth
    torch functions (vectorised with ``torch.func.vmap``).
    """

    spec: object                 # FieldSpec
    uv_model: object             # MLPFieldModel or FourierMLPFieldModel
    dist_fn: Callable
    part_fn: Callable

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        # The composite layout minus the learned factors, so
        # Phase(trainable="uv") works unchanged.
        return {"uv": self.uv_model.init(generator, dtype, device)}

    def jet(self, params, xyt: torch.Tensor, order: Optional[int] = None) -> Jet:
        order = self.spec.jet_order if order is None else order
        uv = self.uv_model.jet(params["uv"], xyt, order=order)
        with span("model.factors", rows=xyt.shape[0], order=order):
            dist = jet_of_fn(self.dist_fn, xyt, order=order)
            part = jet_of_fn(self.part_fn, xyt, order=order)
        return part + dist * uv

    def apply(self, params, xyt: torch.Tensor) -> torch.Tensor:
        uv = self.uv_model.apply(params["uv"], xyt)
        with span("model.factors", rows=xyt.shape[0], order=0):
            part, dist = vmap(self.part_fn)(xyt), vmap(self.dist_fn)(xyt)
        return part + dist * uv
