"""Mixed-variable field models: network outputs are displacements AND stresses.

Counterpart of ``pinn_elastodynamics_tpu/models/fields.py``.  A model is a
static, hashable description plus a separate parameter tree (lists of
``{"W", "b"}`` tensor dicts, nested in dicts for composites), the JAX
package's layout.  ``CompositeFieldModel`` implements the hard-BC
construction u = P + D·ũ as jet algebra.

``jet_impl`` selects the jet: ``"eager"`` (models/mlp.py), ``"kernel"``
(the fused CUDA kernels through their autograd Functions,
kernels/fused_jet_vjp.py; their plain versions on a CPU tensor) or
``"auto"`` (the kernel for a CUDA tensor, eager for a CPU one).  ``init``
methods draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.jet import Jet
from . import mlp as mlp_mod

SECOND_ORDER = "second_order"
FIRST_ORDER = "first_order"
JET_IMPLS = ("eager", "kernel", "auto")

# Channel layouts, 2D.
CH_2D = {
    SECOND_ORDER: ("u", "v", "s11", "s22", "s12"),
    FIRST_ORDER: ("u", "v", "ut", "vt", "s11", "s22", "s12"),
}
# Channel layouts, 3D.
CH_3D = {
    SECOND_ORDER: ("u", "v", "w", "s11", "s22", "s33", "s12", "s13", "s23"),
    FIRST_ORDER: (
        "u", "v", "w", "ut", "vt", "wt",
        "s11", "s22", "s33", "s12", "s13", "s23",
    ),
}


def channel_names(ndim: int, formulation: str) -> Tuple[str, ...]:
    table = CH_2D if ndim == 2 else CH_3D
    return table[formulation]


def use_kernel(jet_impl: str, x: torch.Tensor) -> bool:
    """Whether ``jet_impl`` sends a jet of ``x`` to the fused kernels."""
    if jet_impl not in JET_IMPLS:
        raise ValueError(f"jet_impl must be one of {JET_IMPLS}, got {jet_impl!r}")
    if jet_impl == "auto":
        return x.device.type == "cuda"
    return jet_impl == "kernel"


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of what the field network predicts."""

    ndim: int = 2
    formulation: str = FIRST_ORDER

    @property
    def n_inputs(self) -> int:
        return self.ndim + 1  # spatial coords + time

    @property
    def channels(self) -> Tuple[str, ...]:
        return channel_names(self.ndim, self.formulation)

    @property
    def n_outputs(self) -> int:
        return len(self.channels)

    @property
    def jet_order(self) -> int:
        # Second-order formulation needs d²/dt² of the displacement outputs.
        return 2 if self.formulation == SECOND_ORDER else 1

    def index(self, name: str) -> int:
        return self.channels.index(name)


@dataclasses.dataclass(frozen=True)
class MLPFieldModel:
    """Plain MLP field model (soft-BC cases)."""

    spec: FieldSpec
    hidden: Tuple[int, ...]
    normalize: bool = False
    lb: Optional[Tuple[float, ...]] = None
    ub: Optional[Tuple[float, ...]] = None
    jet_impl: str = "eager"

    @property
    def layers(self) -> Tuple[int, ...]:
        return (self.spec.n_inputs,) + self.hidden + (self.spec.n_outputs,)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        return mlp_mod.init_mlp(generator, self.layers, dtype, device)

    def _norm_args(self):
        if not self.normalize:
            return {"lb": None, "ub": None}
        return {"lb": self.lb, "ub": self.ub}

    def apply(self, params, xyt: torch.Tensor) -> torch.Tensor:
        return mlp_mod.mlp_apply(params, xyt, **self._norm_args())

    def jet(self, params, xyt: torch.Tensor, order: Optional[int] = None) -> Jet:
        order = self.spec.jet_order if order is None else order
        if use_kernel(self.jet_impl, xyt):
            from ..kernels.fused_jet_vjp import fused_jet_vjp

            return fused_jet_vjp(params, xyt, order=order, **self._norm_args())
        return mlp_mod.mlp_jet(params, xyt, order=order, **self._norm_args())


@dataclasses.dataclass(frozen=True)
class CompositeFieldModel:
    """Hard-BC composite u = P + D·ũ per output channel.

    params tree: {'uv': ..., 'dist': ..., 'part': ...}.  ``dist`` regresses
    distance-to-constraint fields and ``part`` the IC/BC values; ``uv`` is
    the free network.
    """

    spec: FieldSpec
    uv_hidden: Tuple[int, ...]
    dist_hidden: Tuple[int, ...]
    part_hidden: Tuple[int, ...]
    # normalize/lb/ub apply to the uv net ONLY (and only when uv_fourier is
    # set — the embedding needs inputs in [-1,1]); dist/part always see raw
    # coordinates (see _sub).
    normalize: bool = False
    lb: Optional[Tuple[float, ...]] = None
    ub: Optional[Tuple[float, ...]] = None
    jet_impl: str = "eager"
    # Random-Fourier-feature embedding on the uv net (0 = plain MLP).
    uv_fourier: int = 0
    uv_fourier_scale: float = 1.0

    def _sub(self, hidden, jet_impl: str = "eager") -> MLPFieldModel:
        return MLPFieldModel(spec=self.spec, hidden=hidden, jet_impl=jet_impl)

    @property
    def uv_net(self):
        if self.uv_fourier:
            from .fourier import FourierMLPFieldModel

            return FourierMLPFieldModel(
                spec=self.spec, hidden=self.uv_hidden,
                n_features=self.uv_fourier,
                feature_scale=self.uv_fourier_scale,
                normalize=self.normalize, lb=self.lb, ub=self.ub,
                jet_impl=self.jet_impl,
            )
        return self._sub(self.uv_hidden, jet_impl=self.jet_impl)

    @property
    def dist_net(self) -> MLPFieldModel:
        return self._sub(self.dist_hidden)

    @property
    def part_net(self) -> MLPFieldModel:
        return self._sub(self.part_hidden)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        return {k: getattr(self, f"{k}_net").init(generator, dtype, device)
                for k in ("uv", "dist", "part")}

    def jet(self, params, xyt: torch.Tensor, order: Optional[int] = None) -> Jet:
        order = self.spec.jet_order if order is None else order
        if not self.uv_fourier and use_kernel(self.jet_impl, xyt):
            # One launch each way for all three nets; they all see raw
            # coordinates.
            from ..kernels.fused_jet_vjp import fused_composite_jet_vjp

            return fused_composite_jet_vjp(params, xyt, order=order)
        uv = self.uv_net.jet(params["uv"], xyt, order=order)
        dist = self.dist_net.jet(params["dist"], xyt, order=order)
        part = self.part_net.jet(params["part"], xyt, order=order)
        return part + dist * uv

    def apply(self, params, xyt: torch.Tensor) -> torch.Tensor:
        uv = self.uv_net.apply(params["uv"], xyt)
        dist = self.dist_net.apply(params["dist"], xyt)
        part = self.part_net.apply(params["part"], xyt)
        return part + dist * uv
