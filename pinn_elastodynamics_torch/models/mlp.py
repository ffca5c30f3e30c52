"""Tanh MLP core with jet (value + derivative) propagation (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/models/mlp.py``.  Parameters are a
list of ``{"W": (fan_in, fan_out), "b": (fan_out,)}`` tensor dicts, the JAX
layout.  ``mlp_jet`` propagates the value, all first input derivatives and,
for ``order == 2``, the second time derivative through the network with one
stacked matmul per layer.  It is the plain version of the fused-jet CUDA
kernels (kernels/fused_jet.py), which run the same recurrence.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..device import resolve_device
from ..ops.jet import Jet

Params = List[dict]  # [{'W': (in, out), 'b': (out,)} per layer]


def truncated_normal_xavier(generator: torch.Generator, shape, dtype,
                            device="cuda") -> torch.Tensor:
    """Xavier/Glorot stddev sqrt(2/(fan_in+fan_out)) times a unit normal
    truncated to [-2, 2] (the reference's ``tf.truncated_normal`` init).

    Drawn on the CPU from ``generator`` and moved to ``device``; torch does
    not reproduce ``jax.random`` bits, only the distribution.
    """
    fan_in, fan_out = shape
    u = torch.empty(shape, dtype=dtype)
    torch.nn.init.trunc_normal_(u, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return (u * scale).to(resolve_device(device))


def init_mlp(generator: torch.Generator, layers: Sequence[int],
             dtype=torch.float32, device="cuda") -> Params:
    """Initialize an MLP ``layers = [in, h1, ..., out]``: Xavier weights,
    zero biases, on ``device`` (the GPU unless the CPU is asked for)."""
    device = resolve_device(device)
    return [{"W": truncated_normal_xavier(generator, (fi, fo), dtype, device),
             "b": torch.zeros((fo,), dtype=dtype, device=device)}
            for fi, fo in zip(layers[:-1], layers[1:])]


def mlp_layers(params: Params) -> List[int]:
    dims = [int(params[0]["W"].shape[0])]
    dims += [int(layer["W"].shape[1]) for layer in params]
    return dims


def _as_vec(v: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _normalize(x, lb, ub):
    lb = _as_vec(lb, x)
    ub = _as_vec(ub, x)
    return 2.0 * (x - lb) / (ub - lb) - 1.0


def mlp_apply(
    params: Params,
    x: torch.Tensor,
    *,
    lb: Optional[Sequence[float]] = None,
    ub: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Plain forward: tanh hidden layers, linear head.

    ``lb``/``ub`` enable the input normalization to ``[-1, 1]``; pass None
    to disable.
    """
    h = x if lb is None else _normalize(x, lb, ub)
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["W"] + layer["b"])
    last = params[-1]
    return h @ last["W"] + last["b"]


def seed_jet(
    x: torch.Tensor,
    *,
    order: int = 1,
    lb: Optional[Sequence[float]] = None,
    ub: Optional[Sequence[float]] = None,
):
    """Input seed streams ``(h, d, dtt)`` of raw or normalized coordinates.

    ``h`` is (N, A), ``d`` is (A, N, A) (the identity, scaled by the
    normalization), ``dtt`` is (N, A) zeros or None.
    """
    n, a = x.shape
    eye = torch.eye(a, dtype=x.dtype, device=x.device)
    if lb is None:
        h = x
    else:
        h = _normalize(x, lb, ub)
        eye = eye * (2.0 / (_as_vec(ub, x) - _as_vec(lb, x)))[None, :]
    d = eye[:, None, :].expand(a, n, a)
    dtt = torch.zeros((n, a), dtype=x.dtype, device=x.device) if order >= 2 else None
    return h, d, dtt


def mlp_jet_from_seed(params: Params, h, d, dtt=None) -> Jet:
    """Run the jet layer recurrence from precomputed input streams.

    The propagation rules per layer (z = h_prev @ W + b, h = tanh(z)):
      dh_i   = (1 - h²) · dz_i
      h_tt   = (1 - h²) · z_tt - 2 h (1 - h²) · z_t²
    The linear head adds its bias to the value stream only.
    """
    for layer in params[:-1]:
        z, dz, ztt = _stacked_matmul(h, d, dtt, layer["W"])
        z = z + layer["b"]
        hh = torch.tanh(z)
        g = 1.0 - hh * hh  # tanh'
        d = g[None] * dz
        if dtt is not None:
            zt = dz[-1]
            dtt = g * ztt - 2.0 * hh * g * (zt * zt)
        h = hh
    f, d, dtt = _stacked_matmul(h, d, dtt, params[-1]["W"])
    return Jet(f=f + params[-1]["b"], d=d, dtt=dtt)


def mlp_jet(
    params: Params,
    x: torch.Tensor,
    *,
    order: int = 1,
    lb: Optional[Sequence[float]] = None,
    ub: Optional[Sequence[float]] = None,
) -> Jet:
    """Forward pass that propagates the full derivative jet.

    Args:
      params: MLP parameters.
      x: (N, A) input coordinates, time last.
      order: 1 → values + first derivatives; 2 → also d²/dt².
    Returns:
      Jet with f (N, C), d (A, N, C), and dtt (N, C) when ``order == 2``.
    """
    h, d, dtt = seed_jet(x, order=order, lb=lb, ub=ub)
    return mlp_jet_from_seed(params, h, d, dtt)


def _stacked_matmul(h, d, dtt, w):
    """One matmul for the value, A tangent, and (optional) dtt streams."""
    a = d.shape[0]
    streams = [h[None], d]
    if dtt is not None:
        streams.append(dtt[None])
    out = torch.cat(streams, dim=0) @ w  # (K, N, out)
    z = out[0]
    dz = out[1 : 1 + a]
    ztt = out[1 + a] if dtt is not None else None
    return z, dz, ztt
