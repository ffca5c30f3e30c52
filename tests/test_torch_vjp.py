"""PyTorch port: the differentiable fused jets (autograd Functions over the
backward kernels B2, B3b and B5) against the JAX custom VJPs, whose Pallas
kernels run in interpret mode (f32), and their plain reverse sweeps against
torch.autograd (f64).

On a CPU tensor each Function runs the plain versions; the CUDA kernels are
held to the same plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.kernels import fused_jet_vjp as jvjp
from pinn_elastodynamics_torch.kernels import _native
from pinn_elastodynamics_torch.kernels import fused_jet as tfj
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as tvjp
from pinn_elastodynamics_torch.models.mlp import mlp_jet_from_seed
from pinn_elastodynamics_torch.utils.tree import tree_leaves

ATOL = 2e-6      # forward values: tests/test_pallas_kernel.py
GRAD_TOL = 2e-4  # gradients, times max(1, max|grad|): tests/test_fused_vjp.py
LB, UB = (0.0, 0.0, 0.0), (0.5, 0.5, 10.0)


def _mlp(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v, dtype) for v in tree]
    return torch.as_tensor(np.asarray(tree), dtype=dtype).requires_grad_()


def _jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _points(rng, n):
    return np.concatenate([rng.uniform(0, 0.5, (n, 2)),
                           rng.uniform(0, 10, (n, 1))], 1)


def _weighted(jet, w):
    """Sum of every stream times fixed weights (S, N, C); the JAX Jet and
    the port's Jet have the same fields."""
    streams = [jet.f, *[jet.d[i] for i in range(jet.d.shape[0])]]
    if jet.dtt is not None:
        streams.append(jet.dtt)
    return sum((s * wi).sum() for s, wi in zip(streams, w))


def _assert_grads(got, want):
    scale = max(1.0, max(float(np.abs(np.asarray(w)).max()) for w in want))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL * scale)


def _seed3(xs):
    """(h0, d, dtt) with dtt None at order 1."""
    return xs[0], xs[1], xs[2] if len(xs) > 2 else None


# kind -> (JAX custom VJP call, port call); each takes (params, inputs).
def _cases(order):
    lbub = (LB, UB)
    return {
        "raw": (
            lambda p, x: jvjp.fused_jet_vjp(p, x[0], order, 64, True),
            lambda p, x: tvjp.fused_jet_vjp(p, x[0], order=order)),
        "normalized": (
            lambda p, x: jvjp.fused_jet_vjp(p, x[0], order, 64, True, *lbub),
            lambda p, x: tvjp.fused_jet_vjp(p, x[0], order=order, lb=LB,
                                            ub=UB)),
        "seeded": (
            lambda p, x: jvjp.fused_seed_jet_vjp(p, *_seed3(x), 64, True),
            lambda p, x: tvjp.fused_seed_jet_vjp(p, *_seed3(x))),
        "composite": (
            lambda p, x: jvjp.fused_composite_jet_vjp(p, x[0], order, 64, True),
            lambda p, x: tvjp.fused_composite_jet_vjp(p, x[0], order=order)),
    }


def _inputs(kind, order, rng, n=150):
    if kind == "seeded":
        e = 12
        params = _mlp(rng, [e, 24, 24, 5])
        seed = [rng.uniform(-1, 1, (n, e)), rng.standard_normal((3, n, e))]
        if order == 2:
            seed.append(rng.standard_normal((n, e)))
        return params, seed
    if kind == "composite":
        params = {"uv": _mlp(rng, [3, 24, 24, 5]), "dist": _mlp(rng, [3, 8, 5]),
                  "part": _mlp(rng, [3, 8, 8, 5])}
    else:
        params = _mlp(rng, [3, 24, 24, 5])
    return params, [_points(rng, n)]


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kind", ["raw", "normalized", "seeded", "composite"])
def test_function_matches_pallas_custom_vjp(kind, order):
    rng = np.random.default_rng(40 + order)
    params, inputs = _inputs(kind, order, rng)
    n = inputs[0].shape[0]
    w = rng.standard_normal((3 + order, n, 5))
    jfn, tfn = _cases(order)[kind]

    def jloss(p, xs):
        return _weighted(jfn(p, xs), jnp.asarray(w, jnp.float32))

    jinputs = [jnp.asarray(a, jnp.float32) for a in inputs]
    jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        _jax(params), jinputs)
    tp = _torch(params)
    tx = [torch.as_tensor(a, dtype=torch.float32).requires_grad_()
          for a in inputs]
    jet = tfn(tp, tx)
    assert jet.f.dtype == torch.float32
    want_jet = jfn(_jax(params), jinputs)
    for name in ("f", "d", "dtt"):
        if getattr(want_jet, name) is not None:
            np.testing.assert_allclose(getattr(jet, name).detach().numpy(),
                                       np.asarray(getattr(want_jet, name)),
                                       rtol=0, atol=ATOL)
    tv = _weighted(jet, torch.as_tensor(w, dtype=torch.float32))
    np.testing.assert_allclose(float(tv.detach()), float(jv),
                               rtol=1e-5, atol=1e-5)
    leaves = tree_leaves(tp)
    got = torch.autograd.grad(tv, leaves + tx)
    _assert_grads(got[:len(leaves)], jax.tree.leaves(jgp))
    _assert_grads(got[len(leaves):], jgx)


def _f64(rng, dims):
    return _torch(_mlp(rng, dims), torch.float64)


@pytest.mark.parametrize("order", [1, 2])
def test_plain_reverse_sweeps_match_autograd(order):
    """The plain B2/B3b and B5 backward against torch.autograd through the
    eager jet, f64."""
    rng = np.random.default_rng(50 + order)
    n, s = 60, 3 + order
    cot = torch.as_tensor(rng.standard_normal((s, n, 5)))

    params = _f64(rng, [7, 16, 11, 5])
    seed = [torch.as_tensor(rng.standard_normal(shape)).requires_grad_()
            for shape in ((n, 7), (3, n, 7), (n, 7))[:2 + (order - 1)]]
    dtt = seed[2] if order == 2 else None
    jet = mlp_jet_from_seed(params, seed[0], seed[1], dtt)
    want = torch.autograd.grad((tfj.stack_jet(jet) * cot).sum(),
                               tree_leaves(params) + seed)
    grads, dseed = tvjp.mlp_jet_bwd_reference(
        params, *[t.detach() for t in seed[:2]],
        None if dtt is None else dtt.detach(), cot)
    got = tree_leaves(grads) + [dseed[0], dseed[1:4]] + (
        [dseed[4]] if order == 2 else [])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)

    comp = {"uv": _f64(rng, [3, 16, 11, 5]), "dist": _f64(rng, [3, 9, 5]),
            "part": _f64(rng, [3, 6, 6, 5])}
    x = torch.as_tensor(_points(rng, n)).requires_grad_()
    for lb, ub in ((None, None), (LB, UB)):
        jet = tfj.fused_composite_jet_reference(comp, x, order=order, lb=lb,
                                                ub=ub)
        want = torch.autograd.grad((tfj.stack_jet(jet) * cot).sum(),
                                   tree_leaves(comp) + [x])
        grads, dh0 = tvjp.composite_jet_bwd_reference(
            comp, x.detach(), cot, order=order, lb=lb, ub=ub)
        if lb is not None:
            dh0 = dh0 * 2.0 / (torch.tensor(UB, dtype=torch.float64)
                         - torch.tensor(LB, dtype=torch.float64))
        got = tree_leaves(grads) + [dh0]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


def test_cpu_backward_launches_no_kernel():
    rng = np.random.default_rng(60)
    params = _torch(_mlp(rng, [3, 8, 5]))
    x = torch.as_tensor(_points(rng, 10), dtype=torch.float32)
    tvjp.reset_launches()
    loss = (tvjp.fused_jet_vjp(params, x, order=2).f.sum()
            + tvjp.fused_composite_jet_vjp(
                {"uv": params, "dist": params, "part": params}, x).dtt.sum())
    loss.backward()
    assert all(l["W"].grad is not None for l in params)
    assert tvjp.LAUNCHES == {"fused_mlp_jet_bwd": 0, "fused_seed_jet_bwd": 0,
                             "fused_composite_jet_bwd": 0}
    assert tvjp.BODIES == {"tile": 0, "wide140": 0}


def test_backward_wrappers_reject_bad_arguments():
    rng = np.random.default_rng(61)
    params = _torch(_mlp(rng, [3, 8, 5]))
    x = torch.as_tensor(_points(rng, 10), dtype=torch.float32)
    cot = torch.zeros(5, 10, 5)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="device"):
        tvjp.fused_composite_jet_bwd(
            {"uv": params, "dist": params, "part": params}, meta,
            cot.to("meta"))
    with pytest.raises(ValueError, match="device"):
        tvjp.fused_mlp_jet_bwd(params, meta, meta.expand(3, 10, 3), None,
                               cot.to("meta"), full_dx=False)
    with pytest.raises(ValueError, match="order"):
        tvjp.fused_composite_jet_bwd(
            {"uv": params, "dist": params, "part": params}, x, cot, order=3)


def test_native_builds_one_library_of_both_sources(tmp_path, monkeypatch):
    assert [p.name for p in _native.SOURCES] == ["fused_jet.cu",
                                                 "fused_jet_vjp.cu"]
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert path.name.startswith("libfused_jet_") and path.suffix == ".so"
    for header in _native.HEADERS:
        assert header.exists()
    # The name changes with either source.
    for i in range(len(_native.SOURCES)):
        copies = [tmp_path / f"{i}_{p.name}" for p in _native.SOURCES]
        for src, dst in zip(_native.SOURCES, copies):
            dst.write_bytes(src.read_bytes())
        copies[i].write_bytes(copies[i].read_bytes() + b"\n")
        monkeypatch.setattr(_native, "SOURCES", tuple(copies))
        assert _native.library_path() != path
    # The launchers' argument lists match the C signatures' arity.
    sig = _native.SIGNATURES
    assert len(sig["fused_mlp_jet_launch"]) == 11
    assert len(sig["fused_composite_jet_launch"]) == 17
    assert len(sig["fused_mlp_jet_bwd_launch"]) == 17   # + workspace
    assert len(_native.QUERIES["fused_mlp_jet_bwd_workspace"][0]) == 4
    assert len(_native.QUERIES["fused_mlp_jet_bwd_body"][0]) == 4
    assert len(sig["fused_composite_jet_bwd_launch"]) == 22   # + workspace
    assert len(_native.QUERIES["fused_composite_jet_bwd_workspace"][0]) == 8
