"""Fourier-feature field model (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/models/fourier.py``.  The embedding
γ(x) = [sin(2π x·B), cos(2π x·B)] has an analytic jet:

    z = 2π x·B           dz_i = 2π B[i]          z_tt = 0
    sin(z):  d = cos(z)·dz_i      dtt = -sin(z)·z_t²
    cos(z):  d = -sin(z)·dz_i     dtt = -cos(z)·z_t²

computed here in plain tensor ops; the MLP tail continues from that seed,
through the fused seeded-jet kernels when ``jet_impl`` selects them (whose
backward returns the seed cotangent, so gradients reach ``B``).  Params
are {'B': (A, F), 'mlp': [...]}.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.jet import Jet
from . import mlp as mlp_mod
from .fields import FieldSpec, use_kernel


@dataclasses.dataclass(frozen=True)
class FourierMLPFieldModel:
    """MLP field model with a random-Fourier-feature input embedding."""

    spec: FieldSpec
    hidden: Tuple[int, ...]
    n_features: int = 64          # F; embedding width is 2F
    feature_scale: float = 1.0    # stddev of B (frequency content)
    normalize: bool = False
    lb: Optional[Tuple[float, ...]] = None
    ub: Optional[Tuple[float, ...]] = None
    jet_impl: str = "eager"

    @property
    def layers(self) -> Tuple[int, ...]:
        return (2 * self.n_features,) + self.hidden + (self.spec.n_outputs,)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        device = resolve_device(device)
        b = self.feature_scale * torch.randn(
            (self.spec.n_inputs, self.n_features), generator=generator,
            dtype=dtype)
        return {"B": b.to(device),
                "mlp": mlp_mod.init_mlp(generator, self.layers, dtype, device)}

    def _normalized(self, x):
        if not self.normalize:
            return x, None
        lb = torch.as_tensor(self.lb, dtype=x.dtype, device=x.device)
        ub = torch.as_tensor(self.ub, dtype=x.dtype, device=x.device)
        scale = 2.0 / (ub - lb)
        return 2.0 * (x - lb) / (ub - lb) - 1.0, scale

    def _embed(self, params, x):
        xn, _ = self._normalized(x)
        z = 2.0 * math.pi * (xn @ params["B"])
        return torch.cat([torch.sin(z), torch.cos(z)], dim=1)

    def apply(self, params, xyt: torch.Tensor) -> torch.Tensor:
        return mlp_mod.mlp_apply(params["mlp"], self._embed(params, xyt))

    def _embed_jet(self, params, xyt, order):
        """Analytic jet of the embedding: (h, d, dtt) as in the module doc."""
        a = xyt.shape[1]
        xn, scale = self._normalized(xyt)
        b = params["B"]
        z = 2.0 * math.pi * (xn @ b)            # (N, F)
        sin, cos = torch.sin(z), torch.cos(z)

        # dz_i = 2π·(scale_i)·B[i]  (constant per input coordinate).
        if scale is None:
            scale = torch.ones((a,), dtype=xyt.dtype, device=xyt.device)
        dz = (2.0 * math.pi * scale)[:, None] * b   # (A, F)
        h = torch.cat([sin, cos], dim=1)
        d = torch.cat(
            [cos[None] * dz[:, None, :], -sin[None] * dz[:, None, :]], dim=2
        )                                            # (A, N, 2F)
        dtt = None
        if order >= 2:
            zt2 = dz[-1][None, :] ** 2               # (1, F)
            dtt = torch.cat([-sin * zt2, -cos * zt2], dim=1)
        return h, d, dtt

    def jet(self, params, xyt: torch.Tensor, order: Optional[int] = None) -> Jet:
        order = self.spec.jet_order if order is None else order
        h, d, dtt = self._embed_jet(params, xyt, order)
        if use_kernel(self.jet_impl, xyt):
            from ..kernels.fused_jet_vjp import fused_seed_jet_vjp

            return fused_seed_jet_vjp(params["mlp"], h, d, dtt)
        return mlp_mod.mlp_jet_from_seed(params["mlp"], h, d, dtt)
