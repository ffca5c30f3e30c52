"""Fused-jet forward kernels: launchers, plain versions and launch counts.

Counterpart of ``pinn_elastodynamics_tpu/kernels/fused_jet.py``.  The Pallas
TPU kernels become two hand-written CUDA kernels (``csrc/fused_jet.cu``):

* ``fused_mlp_jet`` — the whole-MLP jet forward from seed streams, launched
  by :func:`fused_seed_jet_stack` (caller-supplied seed, e.g. a Fourier
  embedding) and :func:`fused_jet_stack` (raw or normalized coordinates,
  seed built here);
* ``fused_composite_jet`` — the uv, dist and part nets on raw points and
  the product-rule combine ``part + dist * uv`` in one launch
  (:func:`fused_composite_jet_stack`).

Each launcher returns the jet's (S, N, C) stream stack and takes the plain
PyTorch version for a tensor on the CPU and the kernel for a CUDA tensor;
anything else raises.  Callers use the differentiable entry points of
``fused_jet_vjp.py``, which run these launchers forward.  The kernels
compute in f32 and take f32, contiguous CUDA tensors.  ``LAUNCHES`` counts
kernel launches by kernel name (one is added where a kernel is launched,
nowhere else).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..models.mlp import Params, mlp_jet, mlp_jet_from_seed, seed_jet
from ..ops.jet import Jet
from . import _native

LAUNCHES = {"fused_mlp_jet": 0, "fused_composite_jet": 0}
# What csrc/fused_jet.cu is instantiated for.
KERNEL_INPUTS = (3, 4)   # input coordinates: 2D or 3D plus time
MAX_LAYERS = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ---------------------------------------------------------

def fused_jet_reference(params: Params, x, *, order: int = 1, lb=None,
                        ub=None) -> Jet:
    """Plain version of :func:`fused_jet_stack`: the eager jet recurrence."""
    return mlp_jet(params, x, order=order, lb=lb, ub=ub)


def fused_seed_jet_reference(params: Params, h0, d, dtt=None) -> Jet:
    """Plain version of :func:`fused_seed_jet_stack`."""
    return mlp_jet_from_seed(params, h0, d, dtt)


def fused_composite_jet_reference(params: dict, x, *, order: int = 2,
                                  lb=None, ub=None) -> Jet:
    """Plain version of :func:`fused_composite_jet_stack`: part + dist·uv."""
    kw = dict(order=order, lb=lb, ub=ub)
    uv = mlp_jet(params["uv"], x, **kw)
    dist = mlp_jet(params["dist"], x, **kw)
    part = mlp_jet(params["part"], x, **kw)
    return part + dist * uv


# -- kernel plumbing --------------------------------------------------------

def _require_f32_cuda(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no fused-jet implementation for device {t.device}")


def pack_params(params: Params, device) -> Tuple[torch.Tensor, List[int]]:
    """Flatten an MLP into one f32 buffer (per layer W row-major, then b)."""
    if not 1 <= len(params) <= MAX_LAYERS:
        raise ValueError(f"the CUDA kernels take 1 to {MAX_LAYERS} layers, "
                         f"got {len(params)}")
    dims = [int(params[0]["W"].shape[0])]
    flat = []
    for i, layer in enumerate(params):
        w, b = layer["W"], layer["b"]
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: W {tuple(w.shape)} and b "
                             f"{tuple(b.shape)} do not chain from {dims[-1]}")
        _require_f32_cuda(f"layer {i} W", w, device)
        _require_f32_cuda(f"layer {i} b", b, device)
        dims.append(int(w.shape[1]))
        flat += [w.reshape(-1), b]
    return torch.cat(flat), dims


def _check_order(order: int) -> None:
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")


def _check_inputs(a: int) -> None:
    if a not in KERNEL_INPUTS:
        raise ValueError(f"the CUDA kernels take {KERNEL_INPUTS} input "
                         f"coordinates, got {a}")


def _int_array(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def _float_array(values: Optional[Sequence[float]]):
    if values is None:
        return None
    return (ctypes.c_float * len(values))(*[float(v) for v in values])


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stack_jet(jet: Jet) -> torch.Tensor:
    """The (S, N, C) stream stack [f; d_0 .. d_{A-1}; dtt] of a jet."""
    parts = [jet.f[None], jet.d]
    if jet.dtt is not None:
        parts.append(jet.dtt[None])
    return torch.cat(parts)


def jet_from_stack(out: torch.Tensor, a: int, order: int) -> Jet:
    """A jet whose streams are views of the (S, N, C) stack ``out``."""
    return Jet(f=out[0], d=out[1 : 1 + a],
               dtt=out[1 + a] if order >= 2 else None)


def _launch_mlp_jet(params: Params, h0, d, dtt) -> torch.Tensor:
    device = h0.device
    for name, t in (("h0", h0), ("d", d), ("dtt", dtt)):
        if t is not None:
            _require_f32_cuda(name, t, device)
    packed, dims = pack_params(params, device)
    if h0.shape[1] != dims[0]:
        raise ValueError(f"seed width {h0.shape[1]} != first layer fan_in "
                         f"{dims[0]}")
    n, a = h0.shape[0], d.shape[0]
    _check_inputs(a)
    order = 2 if dtt is not None else 1
    out = torch.empty((1 + a + (order - 1), n, dims[-1]), dtype=torch.float32,
                      device=device)
    lib = _native.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_mlp_jet_launch(
            h0.data_ptr(), d.data_ptr(), _ptr(dtt), n, a, order,
            packed.data_ptr(), _int_array(dims), len(params),
            out.data_ptr(), stream)
    _native.check(err, "fused_mlp_jet")
    LAUNCHES["fused_mlp_jet"] += 1
    return out


def _check_seed(h0, d, dtt) -> None:
    if h0.ndim != 2 or d.ndim != 3 or d.shape[1:] != h0.shape:
        raise ValueError(f"seed shapes h0 {tuple(h0.shape)} and d "
                         f"{tuple(d.shape)} do not match (A, N, E)")
    if dtt is not None and dtt.shape != h0.shape:
        raise ValueError(f"dtt {tuple(dtt.shape)} != h0 {tuple(h0.shape)}")


# -- launchers ----------------------------------------------------------------
#
# Each returns the jet as its (S, N, C) stream stack, the layout the kernels
# write.  They carry no gradient: the autograd Functions of fused_jet_vjp.py
# call them forward and are the entry points.

def fused_seed_jet_stack(params: Params, h0, d, dtt=None) -> torch.Tensor:
    _check_seed(h0, d, dtt)
    if _on_cpu(h0):
        return stack_jet(fused_seed_jet_reference(params, h0, d, dtt))
    return _launch_mlp_jet(params, h0, d, dtt)


def fused_jet_stack(params: Params, x, *, order: int = 1, lb=None,
                    ub=None) -> torch.Tensor:
    if x.ndim != 2:
        raise ValueError(f"x must be (N, A), got {tuple(x.shape)}")
    _check_order(order)
    if _on_cpu(x):
        return stack_jet(fused_jet_reference(params, x, order=order, lb=lb,
                                             ub=ub))
    _require_f32_cuda("x", x, x.device)
    h0, d, dtt = seed_jet(x, order=order, lb=lb, ub=ub)
    return _launch_mlp_jet(params, h0.contiguous(), d.contiguous(), dtt)


def fused_composite_jet_stack(params: dict, x, *, order: int = 2, lb=None,
                              ub=None) -> torch.Tensor:
    if x.ndim != 2:
        raise ValueError(f"x must be (N, A), got {tuple(x.shape)}")
    if (lb is None) != (ub is None):
        raise ValueError("pass both lb and ub, or neither")
    _check_order(order)
    if _on_cpu(x):
        return stack_jet(fused_composite_jet_reference(params, x, order=order,
                                                       lb=lb, ub=ub))
    device = x.device
    _require_f32_cuda("x", x, device)
    n, a = x.shape
    _check_inputs(a)
    nets = [pack_params(params[k], device) for k in ("uv", "dist", "part")]
    c = nets[0][1][-1]
    for name, (_, dims) in zip(("uv", "dist", "part"), nets):
        if dims[0] != a or dims[-1] != c:
            raise ValueError(f"{name} net maps {dims[0]} -> {dims[-1]}, "
                             f"expected {a} -> {c}")
    out = torch.empty((1 + a + (order - 1), n, c), dtype=torch.float32,
                      device=device)
    args = []
    for packed, dims in nets:
        args += [packed.data_ptr(), _int_array(dims), len(dims) - 1]
    lib = _native.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_composite_jet_launch(
            x.data_ptr(), n, a, order, _float_array(lb), _float_array(ub),
            *args, out.data_ptr(), stream)
    _native.check(err, "fused_composite_jet")
    LAUNCHES["fused_composite_jet"] += 1
    return out
