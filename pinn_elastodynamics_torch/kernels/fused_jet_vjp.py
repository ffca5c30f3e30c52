"""Differentiable fused jets: autograd Functions over the CUDA kernels.

Counterpart of ``pinn_elastodynamics_tpu/kernels/fused_jet_vjp.py``.  Each
``jax.custom_vjp`` there becomes a ``torch.autograd.Function`` here:

* :func:`fused_jet_vjp` — MLP jet of raw or normalized coordinates; forward
  B1 (``fused_mlp_jet``), backward B2 (``fused_mlp_jet_bwd``: the
  value-row seed cotangent, chained through the normalization);
* :func:`fused_seed_jet_vjp` — MLP jet from a caller-supplied seed (the
  Fourier embedding); forward B1, backward B3b (``fused_seed_jet_bwd``: the
  full seed cotangent, so gradients reach the embedding);
* :func:`fused_composite_jet_vjp` — ``part + dist·uv`` of three nets;
  forward B4, backward B5 (``fused_composite_jet_bwd``).

Like JAX, a forward saves only its inputs and the backward recomputes the
activations (``csrc/fused_jet_vjp.cu``).  Parameters enter as flat leaf
tensors so that autograd sees them; the output is the (S, N, C) stream
stack, so the cotangent arrives in the layout the kernels read, and the Jet
returned to the caller holds views of it (an unused stream's cotangent is
materialized as zeros, as JAX's ``None`` becomes zeros).  The Functions are
``once_differentiable``.

On a CPU tensor the forward and backward take their plain versions
(:func:`mlp_jet_bwd_reference`, :func:`composite_jet_bwd_reference`: the
``_remat_forward`` / ``_reverse_sweep`` recurrence in PyTorch, any float
dtype); on a CUDA tensor they launch the kernels or raise.  ``LAUNCHES``
counts the backward kernels' launches, ``BODIES`` the B2/B3b launches by the
kernel body the library chose for the net's widths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..models.mlp import Params, seed_jet
from ..ops.jet import Jet
from . import _native
from .fused_jet import (
    _check_inputs,
    _check_order,
    _float_array,
    _int_array,
    _on_cpu,
    _require_f32_cuda,
    fused_composite_jet_stack,
    fused_jet_stack,
    fused_seed_jet_stack,
    jet_from_stack,
    pack_params,
)

LAUNCHES = {"fused_mlp_jet_bwd": 0, "fused_seed_jet_bwd": 0,
            "fused_composite_jet_bwd": 0}
# B2 and B3b launches by the kernel body they ran, in the order of the
# library's fused_mlp_jet_bwd_body query: the wide-tile body, and the body for
# nets too wide for two weight buffers (the 140-wide ones; 100 x 8 at 32
# points).  Not part of LAUNCHES.
BODIES = {"tile": 0, "wide140": 0}
NETS = ("uv", "dist", "part")


def reset_launches() -> None:
    for counts in (LAUNCHES, BODIES):
        for name in counts:
            counts[name] = 0


# -- plain versions ---------------------------------------------------------

def _seed_stack(h0, d, dtt):
    return torch.cat([h0[None], d] + ([dtt[None]] if dtt is not None else []))


def remat_forward(params: Params, s: torch.Tensor, order: int):
    """Every layer's input stack [s_0, .., s_{L-1}], each (S, N, width),
    from the seed stack ``s`` (``_remat_forward``)."""
    saved = [s]
    n_tan = s.shape[0] - 1 - (1 if order >= 2 else 0)
    for layer in params[:-1]:
        z = s @ layer["W"]
        h = torch.tanh(z[0] + layer["b"])
        g = 1.0 - h * h
        parts = [h[None], g * z[1 : 1 + n_tan]]
        if order >= 2:
            zt = z[n_tan]
            parts.append((g * z[-1] - 2.0 * h * g * (zt * zt))[None])
        s = torch.cat(parts)
        saved.append(s)
    return saved


def reverse_sweep(params: Params, saved, c: torch.Tensor, order: int):
    """Reverse stacked-stream sweep (``_reverse_sweep``) from the output
    cotangent stack ``c``.  Returns the gradients (the parameters' layout)
    and the seed cotangent stack (S, N, E)."""
    n_layers = len(params)
    n_streams = c.shape[0]
    n_tan = n_streams - 1 - (1 if order >= 2 else 0)

    def dw(s_in, cs):
        return s_in.reshape(-1, s_in.shape[-1]).T @ cs.reshape(-1, cs.shape[-1])

    grads: List[Optional[dict]] = [None] * n_layers
    head = params[-1]
    grads[-1] = {"W": dw(saved[-1], c), "b": c[0].sum(0)}
    c = c @ head["W"].T
    for l in range(n_layers - 2, -1, -1):
        s_in, h = saved[l], saved[l + 1][0]
        g = 1.0 - h * h
        z = s_in[1:] @ params[l]["W"]          # streams 1 .. S-1
        ci = c[1 : 1 + n_tan]
        chh = c[0] - 2.0 * h * (ci * z[:n_tan]).sum(0)
        parts = list(g * ci)
        if order >= 2:
            zt, ztt, ctt = z[n_tan - 1], z[-1], c[-1]
            chh = chh + ctt * (-2.0 * h * ztt
                               - 2.0 * (1.0 - 3.0 * h * h) * (zt * zt))
            parts[-1] = parts[-1] + ctt * (-4.0 * h * g * zt)
            parts.append(g * ctt)
        c0 = g * chh
        stack = torch.stack([c0] + parts)
        grads[l] = {"W": dw(s_in, stack), "b": c0.sum(0)}
        c = stack @ params[l]["W"].T
    return grads, c


def _head(params: Params, s_last: torch.Tensor) -> torch.Tensor:
    """A net's output stack from its last layer input (``_final_out``)."""
    out = s_last @ params[-1]["W"]
    return torch.cat([(out[0] + params[-1]["b"])[None], out[1:]])


def mlp_jet_bwd_reference(params: Params, h0, d, dtt, cot):
    """Plain version of the B2/B3b kernel: (gradients, seed cotangent
    (S, N, E)) of the MLP jet from the seed (h0, d, dtt) for the output
    cotangent stack ``cot`` (S, N, C)."""
    order = 2 if dtt is not None else 1
    saved = remat_forward(params, _seed_stack(h0, d, dtt), order)
    return reverse_sweep(params, saved, cot, order)


def composite_jet_bwd_reference(params: dict, x, cot, *, order: int = 2,
                                lb=None, ub=None):
    """Plain version of the B5 kernel: (gradients {'uv', 'dist', 'part'},
    dh0 (N, A)) of ``part + dist·uv`` for the cotangent stack ``cot``;
    dh0 is the cotangent of the (normalized) value seed, summed over the
    three nets."""
    h, d, dtt = seed_jet(x, order=order, lb=lb, ub=ub)
    s = _seed_stack(h, d, dtt)
    saved = {k: remat_forward(params[k], s, order) for k in NETS}
    su = _head(params["uv"], saved["uv"][-1])
    sd = _head(params["dist"], saved["dist"][-1])
    # Reverse of y = sp + sd·su (rows: value, tangents, dtt with
    # y_tt = p_tt + d_tt u + 2 d_t u_t + d u_tt).
    u0, d0 = su[0], sd[0]
    cu = torch.cat([(sd * cot).sum(0)[None], d0 * cot[1:]])
    cd = torch.cat([(su * cot).sum(0)[None], u0 * cot[1:]])
    if order >= 2:
        t = cot.shape[0] - 2   # the time tangent
        cu[t] = cu[t] + 2.0 * sd[t] * cot[-1]
        cd[t] = cd[t] + 2.0 * su[t] * cot[-1]
    grads, dh0 = {}, 0.0
    for k, ck in (("part", cot), ("uv", cu), ("dist", cd)):
        grads[k], cs = reverse_sweep(params[k], saved[k], ck, order)
        dh0 = dh0 + cs[0]
    return grads, dh0


# -- kernel plumbing --------------------------------------------------------

def _unpack_grads(flat: torch.Tensor, dims: Sequence[int]) -> List[dict]:
    grads, off = [], 0
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = flat[off : off + fi * fo].view(fi, fo)
        off += fi * fo
        grads.append({"W": w, "b": flat[off : off + fo]})
        off += fo
    return grads


def _max_blocks(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cot(cot, s: int, n: int, c: int) -> None:
    if tuple(cot.shape) != (s, n, c):
        raise ValueError(f"cotangent {tuple(cot.shape)} != {(s, n, c)}")


def _launch_mlp_bwd(params: Params, h0, d, dtt, cot, full_dx: bool, key: str):
    device = h0.device
    for name, t in (("h0", h0), ("d", d), ("dtt", dtt), ("cot", cot)):
        if t is not None:
            _require_f32_cuda(name, t, device)
    packed, dims = pack_params(params, device)
    n, e = h0.shape
    a = d.shape[0]
    _check_inputs(a)
    order = 2 if dtt is not None else 1
    s = 1 + a + (order - 1)
    _check_cot(cot, s, n, dims[-1])
    lib = _native.library()
    per_block = lib.fused_mlp_jet_bwd_workspace(a, order, _int_array(dims),
                                                len(params))
    if per_block < 0:
        raise ValueError(f"the backward kernel does not take a net of widths "
                         f"{dims} at order {order}")
    max_blocks = _max_blocks(device)
    partial = torch.empty((max_blocks, packed.numel()), dtype=torch.float32,
                          device=device)
    workspace = torch.empty(max(1, max_blocks * per_block),
                            dtype=torch.float32, device=device)
    grad = torch.empty_like(packed)
    dseed = torch.empty((s, n, e) if full_dx else (n, e), dtype=torch.float32,
                        device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_mlp_jet_bwd_launch(
            h0.data_ptr(), d.data_ptr(), None if dtt is None else dtt.data_ptr(),
            cot.data_ptr(), n, a, order, packed.data_ptr(), _int_array(dims),
            len(params), int(full_dx), max_blocks, partial.data_ptr(),
            grad.data_ptr(), dseed.data_ptr(), workspace.data_ptr(), stream)
    _native.check(err, key)
    LAUNCHES[key] += 1
    count_body(lib, a, order, dims)
    return _unpack_grads(grad, dims), dseed


def count_body(lib, a: int, order: int, dims: Sequence[int]) -> None:
    """Count one B2/B3b launch in ``BODIES`` under the body that ``lib``
    runs for a net of widths ``dims``."""
    body = lib.fused_mlp_jet_bwd_body(a, order, _int_array(dims), len(dims) - 1)
    BODIES[list(BODIES)[body]] += 1


# -- backward wrappers --------------------------------------------------------

def fused_mlp_jet_bwd(params: Params, h0, d, dtt, cot, *,
                      full_dx: bool) -> Tuple[List[dict], torch.Tensor]:
    """Backward of the seeded MLP jet: (gradients, seed cotangent).

    ``full_dx`` returns the whole seed cotangent (S, N, E) (B3b); otherwise
    only its value rows (N, E) (B2).
    """
    if _on_cpu(h0):
        grads, dseed = mlp_jet_bwd_reference(params, h0, d, dtt, cot)
        return grads, dseed if full_dx else dseed[0]
    key = "fused_seed_jet_bwd" if full_dx else "fused_mlp_jet_bwd"
    return _launch_mlp_bwd(params, h0, d, dtt, cot, full_dx, key)


def fused_composite_jet_bwd(params: dict, x, cot, *, order: int = 2, lb=None,
                            ub=None) -> Tuple[Dict[str, List[dict]],
                                              torch.Tensor]:
    """Backward of the composite jet (B5): (gradients, dh0)."""
    _check_order(order)
    if _on_cpu(x):
        return composite_jet_bwd_reference(params, x, cot, order=order,
                                           lb=lb, ub=ub)
    device = x.device
    _require_f32_cuda("x", x, device)
    _require_f32_cuda("cot", cot, device)
    n, a = x.shape
    _check_inputs(a)
    nets = [pack_params(params[k], device) for k in NETS]
    _check_cot(cot, 1 + a + (order - 1), n, nets[0][1][-1])
    sizes = [packed.numel() for packed, _ in nets]
    lib = _native.library()
    widths = []
    for _, dims in nets:
        widths += [_int_array(dims), len(dims) - 1]
    per_block = lib.fused_composite_jet_bwd_workspace(a, order, *widths)
    if per_block < 0:
        raise ValueError(f"the composite backward kernel does not take nets "
                         f"of widths {[dims for _, dims in nets]} at order "
                         f"{order}")
    max_blocks = _max_blocks(device)
    partial = torch.empty((max_blocks, sum(sizes)), dtype=torch.float32,
                          device=device)
    workspace = torch.empty(max(1, max_blocks * per_block),
                            dtype=torch.float32, device=device)
    grad = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    dh0 = torch.empty((n, a), dtype=torch.float32, device=device)
    args = []
    for packed, dims in nets:
        args += [packed.data_ptr(), _int_array(dims), len(dims) - 1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_composite_jet_bwd_launch(
            x.data_ptr(), n, a, order, _float_array(lb), _float_array(ub),
            *args, cot.data_ptr(), max_blocks, partial.data_ptr(),
            grad.data_ptr(), dh0.data_ptr(), workspace.data_ptr(), stream)
    _native.check(err, "fused_composite_jet_bwd")
    LAUNCHES["fused_composite_jet_bwd"] += 1
    flats = torch.split(grad, sizes)
    grads = {k: _unpack_grads(f, dims)
             for k, f, (_, dims) in zip(NETS, flats, nets)}
    return grads, dh0


# -- autograd Functions -----------------------------------------------------

def _leaves(params: Params) -> List[torch.Tensor]:
    return [t for layer in params for t in (layer["W"], layer["b"])]


def _params(leaves: Sequence[torch.Tensor]) -> Params:
    return [{"W": leaves[i], "b": leaves[i + 1]}
            for i in range(0, len(leaves), 2)]


def _norm_scale(x, lb, ub):
    """d(normalized x)/dx per coordinate, or None without normalization."""
    if lb is None:
        return None
    lb = torch.as_tensor(lb, dtype=x.dtype, device=x.device)
    ub = torch.as_tensor(ub, dtype=x.dtype, device=x.device)
    return 2.0 / (ub - lb)


class _FusedJet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, lb, ub, *leaves):
        ctx.order, ctx.lb, ctx.ub = order, lb, ub
        ctx.save_for_backward(x, *leaves)
        return fused_jet_stack(_params(leaves), x, order=order, lb=lb, ub=ub)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        x, *leaves = ctx.saved_tensors
        h0, d, dtt = seed_jet(x, order=ctx.order, lb=ctx.lb, ub=ctx.ub)
        grads, dx = fused_mlp_jet_bwd(
            _params(leaves), h0.contiguous(), d.contiguous(), dtt,
            cot.contiguous(), full_dx=False)
        scale = _norm_scale(x, ctx.lb, ctx.ub)
        if scale is not None:
            dx = dx * scale
        return (dx, None, None, None, *_leaves(grads))


class _FusedSeedJet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, d, dtt, *leaves):
        ctx.save_for_backward(h0, d, dtt, *leaves)
        return fused_seed_jet_stack(_params(leaves), h0, d, dtt)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        h0, d, dtt, *leaves = ctx.saved_tensors
        grads, dseed = fused_mlp_jet_bwd(_params(leaves), h0, d, dtt,
                                         cot.contiguous(), full_dx=True)
        a = d.shape[0]
        ddtt = dseed[1 + a] if dtt is not None else None
        return (dseed[0], dseed[1 : 1 + a], ddtt, *_leaves(grads))


class _FusedCompositeJet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, lb, ub, counts, *leaves):
        ctx.order, ctx.lb, ctx.ub, ctx.counts = order, lb, ub, counts
        ctx.save_for_backward(x, *leaves)
        return fused_composite_jet_stack(_split(leaves, counts), x,
                                         order=order, lb=lb, ub=ub)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        x, *leaves = ctx.saved_tensors
        grads, dx = fused_composite_jet_bwd(
            _split(leaves, ctx.counts), x, cot.contiguous(), order=ctx.order,
            lb=ctx.lb, ub=ctx.ub)
        scale = _norm_scale(x, ctx.lb, ctx.ub)
        if scale is not None:
            dx = dx * scale
        flat = [t for k in NETS for t in _leaves(grads[k])]
        return (dx, None, None, None, None, *flat)


def _split(leaves, counts) -> dict:
    out, i = {}, 0
    for k, c in zip(NETS, counts):
        out[k] = _params(leaves[i : i + c])
        i += c
    return out


# -- entry points -------------------------------------------------------------

def fused_jet_vjp(params: Params, x, *, order: int = 1, lb=None,
                  ub=None) -> Jet:
    """MLP jet of (N, A) coordinates (``mlp_jet``), normalized by ``lb``/``ub``
    when given: forward B1, gradients reach ``params`` and ``x`` through the
    B2 backward."""
    out = _FusedJet.apply(x, order, lb, ub, *_leaves(params))
    return jet_from_stack(out, x.shape[1], order)


def fused_seed_jet_vjp(params: Params, h0, d, dtt=None) -> Jet:
    """MLP jet from a precomputed seed (e.g. an embedding): ``h0`` (N, E)
    value rows, ``d`` (A, N, E) tangent rows, ``dtt`` optional (N, E).
    Forward B1; gradients reach ``params`` and every seed stream (and
    through them the embedding) via B3b."""
    out = _FusedSeedJet.apply(h0, d, dtt, *_leaves(params))
    return jet_from_stack(out, d.shape[0], 2 if dtt is not None else 1)


def fused_composite_jet_vjp(params: dict, x, *, order: int = 2, lb=None,
                            ub=None) -> Jet:
    """Composite jet ``part + dist·uv`` of three MLPs that all see the same
    seed (raw coordinates, or normalized by ``lb``/``ub``): forward B4 in one
    launch, gradients reach all three nets and ``x`` through B5."""
    leaves = [_leaves(params[k]) for k in NETS]
    out = _FusedCompositeJet.apply(x, order, lb, ub,
                                   tuple(len(l) for l in leaves),
                                   *[t for l in leaves for t in l])
    return jet_from_stack(out, x.shape[1], order)
