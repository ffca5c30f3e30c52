"""Plain tanh-MLP jets: the arithmetic every reference of the benchmark
shares.

A net is a list of ``(W, b)`` pairs, ``W`` of shape (fan_in, fan_out); the
hidden layers are ``tanh(h W + b)`` and the head is linear.  A jet carries
the value, the first derivative along each input coordinate and, at order
2, the second derivative along the last coordinate (time), each stream with
its own matrix product.  The propagation is the chain rule: for
``y = tanh(z)``, ``g = 1 - y²``, the tangents are ``g·z_i`` and the second
time derivative is ``g·z_tt - 2·y·g·z_t²``.

``precision`` names the arithmetic: ``"float64"`` (the reference),
``"float32"``, or ``"tf32"`` (float32 with both operands of every matrix
product, forward and backward, rounded to TF32's 10-bit mantissa first, as
the tensor cores take them: the control of the correctness check).
Nothing here imports the program.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    bits = torch.bitwise_and(bits + 0xFFF + lsb, -(1 << 13))
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ w`` with both operands rounded to TF32, forward and backward
    (the cotangent rounded too), as the tensor cores multiply."""

    @staticmethod
    def forward(ctx, a, w):
        a, w = tf32_round(a), tf32_round(w)
        ctx.save_for_backward(a, w)
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = tf32_round(g)
        return g @ w.T, a.T @ g


def matmul(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _TF32MatMul.apply(a, w)
    return a @ w


def cast_net(net, precision: str, device=None):
    """The net's weights in the precision's dtype (copies)."""
    dt = dtype_of(precision)
    return [(w.to(device=device, dtype=dt), b.to(device=device, dtype=dt))
            for w, b in net]


class Jet:
    """Value ``f`` (N, C), tangents ``d`` (a list of (N, C), one per input
    coordinate) and ``tt`` (N, C) or None."""

    def __init__(self, f, d, tt=None):
        self.f, self.d, self.tt = f, d, tt

    def __add__(self, o: "Jet") -> "Jet":
        tt = None if self.tt is None else self.tt + o.tt
        return Jet(self.f + o.f, [a + b for a, b in zip(self.d, o.d)], tt)

    def __mul__(self, o: "Jet") -> "Jet":
        """The product rule; ``tt`` needs the time tangents (the last)."""
        tt = None
        if self.tt is not None:
            tt = (self.tt * o.f + 2.0 * self.d[-1] * o.d[-1]
                  + self.f * o.tt)
        return Jet(self.f * o.f, [a * o.f + self.f * b
                                  for a, b in zip(self.d, o.d)], tt)


def jet(net, x: torch.Tensor, order: int, precision: str) -> Jet:
    """The jet of ``net`` at points ``x`` (N, A)."""
    n, a = x.shape
    h = x
    d = []
    for i in range(a):
        e = torch.zeros_like(x)
        e[:, i] = 1.0
        d.append(e)
    tt = torch.zeros_like(x) if order >= 2 else None
    for w, b in net[:-1]:
        z = matmul(h, w, precision) + b
        dz = [matmul(t, w, precision) for t in d]
        y = torch.tanh(z)
        g = 1.0 - y * y
        if tt is not None:
            tt = g * matmul(tt, w, precision) - 2.0 * y * g * dz[-1] * dz[-1]
        d = [g * t for t in dz]
        h = y
    w, b = net[-1]
    f = matmul(h, w, precision) + b
    d = [matmul(t, w, precision) for t in d]
    if tt is not None:
        tt = matmul(tt, w, precision)
    return Jet(f, d, tt)


def forward(net, x: torch.Tensor, precision: str) -> torch.Tensor:
    """The net's value alone."""
    h = x
    for w, b in net[:-1]:
        h = torch.tanh(matmul(h, w, precision) + b)
    w, b = net[-1]
    return matmul(h, w, precision) + b


def composite_jet(nets: dict, x: torch.Tensor, order: int,
                  precision: str) -> Jet:
    """``part + dist·uv``, each channel, as a jet."""
    uv = jet(nets["uv"], x, order, precision)
    dist = jet(nets["dist"], x, order, precision)
    part = jet(nets["part"], x, order, precision)
    return part + dist * uv


def composite_forward(nets: dict, x: torch.Tensor,
                      precision: str) -> torch.Tensor:
    return (forward(nets["part"], x, precision)
            + forward(nets["dist"], x, precision)
            * forward(nets["uv"], x, precision))


def row_blocks(n: int, block: int) -> List[Tuple[int, int]]:
    return [(s, min(n, s + block)) for s in range(0, n, block)]


def as_tensor(a, precision: str, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype_of(precision), device=device)

