"""First/second-order jet algebra for PINN residual assembly (PyTorch).

A :class:`Jet` carries a batch of field values together with their first
derivatives w.r.t. the spacetime inputs ``(x, y, t)`` (or ``(x, y, z, t)`` in
3D) and, optionally, the second derivative w.r.t. time.  Network forwards
propagate jets (``models/mlp.py``); composite hard-BC models combine jets by
linearity and the product rule.  Counterpart of
``pinn_elastodynamics_tpu/ops/jet.py``, with the same layout: ``f`` is
(N, C), ``d`` is (A, N, C), ``dtt`` is (N, C).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import jvp, vmap


@dataclasses.dataclass(frozen=True)
class Jet:
    """Batched value + derivative bundle.

    Attributes:
      f:   (N, C) field values.
      d:   (A, N, C) first derivatives; axis 0 enumerates the input
           coordinates in order (x, y[, z], t).  ``None`` if not computed.
      dtt: (N, C) second derivative w.r.t. the last input coordinate (time),
           or ``None`` when the first-order formulation is in use.
    """

    f: torch.Tensor
    d: Optional[torch.Tensor] = None
    dtt: Optional[torch.Tensor] = None

    def __getitem__(self, idx) -> "Jet":
        """Select output channels (last axis)."""
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return Jet(
            f=self.f[..., idx],
            d=None if self.d is None else self.d[..., idx],
            dtt=None if self.dtt is None else self.dtt[..., idx],
        )

    @property
    def n_inputs(self) -> int:
        if self.d is None:
            raise ValueError("Jet carries no first derivatives")
        return self.d.shape[0]

    def dx(self, i: int) -> torch.Tensor:
        """First derivative w.r.t. input coordinate ``i`` — shape (N, C)."""
        return self.d[i]

    @property
    def dt(self) -> torch.Tensor:
        """First time derivative (time is always the last input coordinate)."""
        return self.d[-1]

    def __add__(self, other: "Jet") -> "Jet":
        return Jet(
            f=self.f + other.f,
            d=_addn(self.d, other.d),
            dtt=_addn(self.dtt, other.dtt),
        )

    def __sub__(self, other: "Jet") -> "Jet":
        return Jet(
            f=self.f - other.f,
            d=_subn(self.d, other.d),
            dtt=_subn(self.dtt, other.dtt),
        )

    def __mul__(self, other) -> "Jet":
        if not isinstance(other, Jet):  # scalar / tensor constant
            return Jet(
                f=self.f * other,
                d=None if self.d is None else self.d * other,
                dtt=None if self.dtt is None else self.dtt * other,
            )
        # Product rule.  (fg)' = f'g + fg';  (fg)_tt = f_tt g + 2 f_t g_t + f g_tt.
        f = self.f * other.f
        d = None
        if self.d is not None and other.d is not None:
            d = self.d * other.f[None] + self.f[None] * other.d
        dtt = None
        if self.dtt is not None and other.dtt is not None:
            dtt = (
                self.dtt * other.f
                + 2.0 * self.dt * other.dt
                + self.f * other.dtt
            )
        return Jet(f=f, d=d, dtt=dtt)

    __rmul__ = __mul__


def _addn(a, b):
    if a is None or b is None:
        return None
    return a + b


def _subn(a, b):
    if a is None or b is None:
        return None
    return a - b


def input_jet(xyt: torch.Tensor, *, order: int = 1) -> Jet:
    """Seed jet for the network input: value = coordinates, d = identity.

    Args:
      xyt: (N, A) coordinates; the last column is time.
      order: 1 for first derivatives only, 2 to also track d²/dt².
    """
    n, a = xyt.shape
    eye = torch.eye(a, dtype=xyt.dtype, device=xyt.device)
    d = eye[:, None, :].expand(a, n, a)
    dtt = torch.zeros_like(xyt) if order >= 2 else None
    return Jet(f=xyt, d=d, dtt=dtt)


def jet_of_fn(fn_point, xyt: torch.Tensor, *, order: int = 1) -> Jet:
    """Jet of a smooth per-point function via forward-mode AD.

    ``fn_point`` maps one coordinate vector (A,) to field values (C,); it is
    vectorised over the points with ``torch.func.vmap``.  Each first
    derivative is one ``jvp`` with the unit tangent of its input coordinate
    on every point, and ``dtt`` is a ``jvp`` nested in a ``jvp`` along time.
    Used for the closed-form composite factors (models/analytic_bc.py).
    """
    n, a = xyt.shape
    fn = vmap(fn_point)

    def unit(i):
        e = torch.zeros_like(xyt)
        e[:, i] = 1.0
        return e

    f = fn(xyt)
    d = torch.stack([jvp(fn, (xyt,), (unit(i),))[1] for i in range(a)])
    dtt = None
    if order >= 2:
        et = unit(a - 1)
        dtt = jvp(lambda p: jvp(fn, (p,), (et,))[1], (xyt,), (et,))[1]
    return Jet(f=f, d=d, dtt=dtt)
