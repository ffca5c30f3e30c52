"""PyTorch port: jet algebra and the MLP jet against the JAX package (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.models import mlp as jmlp
from pinn_elastodynamics_tpu.ops import jet as jjet
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.models import mlp as tmlp
from pinn_elastodynamics_torch.ops import jet as tjet

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float64), jnp.float64)


def _random_jet(rng, n=17, c=5, a=3, order=2):
    return (rng.standard_normal((n, c)), rng.standard_normal((a, n, c)),
            rng.standard_normal((n, c)) if order == 2 else None)


def _pair(parts):
    f, d, dtt = parts
    return (jjet.Jet(f=_j(f), d=_j(d), dtt=None if dtt is None else _j(dtt)),
            tjet.Jet(f=_t(f), d=_t(d), dtt=None if dtt is None else _t(dtt)))


def _assert_jet(tj, jj, tol):
    np.testing.assert_allclose(tj.f.numpy(), np.asarray(jj.f), rtol=0, atol=tol)
    np.testing.assert_allclose(tj.d.numpy(), np.asarray(jj.d), rtol=0, atol=tol)
    if jj.dtt is None:
        assert tj.dtt is None
    else:
        np.testing.assert_allclose(tj.dtt.numpy(), np.asarray(jj.dtt),
                                   rtol=0, atol=tol)


def _mlp_params(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


def _to(params, conv):
    return [{k: conv(v) for k, v in layer.items()} for layer in params]


@pytest.mark.parametrize("order", [1, 2])
def test_jet_algebra_matches_jax(order):
    rng = np.random.default_rng(0)
    ja, ta = _pair(_random_jet(rng, order=order))
    jb, tb = _pair(_random_jet(rng, order=order))
    scale = rng.standard_normal(5)
    for got, want in [
        (ta + tb, ja + jb),
        (ta - tb, ja - jb),
        (ta * tb, ja * jb),
        (ta * _t(scale), ja * _j(scale)),
        (2.5 * ta, 2.5 * ja),
        (ta[1], ja[1]),
        (ta[1:4], ja[1:4]),
    ]:
        _assert_jet(got, want, 1e-12)
    assert ta.n_inputs == 3
    np.testing.assert_array_equal(ta.dt.numpy(), np.asarray(ja.dt))
    np.testing.assert_array_equal(ta.dx(1).numpy(), np.asarray(ja.dx(1)))


def test_jet_without_derivatives():
    f = tjet.Jet(f=torch.ones(4, 2, dtype=F64))
    with pytest.raises(ValueError):
        f.n_inputs
    assert (f + f).d is None and (f * f).dtt is None


@pytest.mark.parametrize("order", [1, 2])
def test_input_jet_matches_jax(order):
    x = np.random.default_rng(1).uniform(size=(11, 3))
    _assert_jet(tjet.input_jet(_t(x), order=order),
                jjet.input_jet(_j(x), order=order), 0.0)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", ["analytic_dist", "analytic_part"])
def test_jet_of_fn_on_plate_factors(name, order):
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0, 0.5, (64, 2)), rng.uniform(0, 10, (64, 1))],
                       axis=1)
    got = tjet.jet_of_fn(getattr(tplate, name), _t(x), order=order)
    want = jjet.jet_of_fn(getattr(jplate, name), _j(x), order=order)
    _assert_jet(got, want, 1e-12)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_mlp_jet_matches_jax(order, norm):
    rng = np.random.default_rng(3)
    params = _mlp_params(rng, [3, 70, 70, 5])
    x = rng.uniform(0, 10, (333, 3))
    kw = dict(lb=(0.0, 0.0, 0.0), ub=(10.0, 10.0, 20.0)) if norm else {}
    got = tmlp.mlp_jet(_to(params, _t), _t(x), order=order, **kw)
    want = jmlp.mlp_jet(_to(params, _j), _j(x), order=order, **kw)
    _assert_jet(got, want, 1e-11)
    assert tmlp.mlp_layers(_to(params, _t)) == [3, 70, 70, 5]


@pytest.mark.parametrize("norm", [False, True])
def test_mlp_apply_matches_jax(norm):
    rng = np.random.default_rng(4)
    params = _mlp_params(rng, [3, 20, 20, 5])
    x = rng.uniform(0, 10, (50, 3))
    kw = dict(lb=(0.0, 0.0, 0.0), ub=(10.0, 10.0, 20.0)) if norm else {}
    got = tmlp.mlp_apply(_to(params, _t), _t(x), **kw)
    want = jmlp.mlp_apply(_to(params, _j), _j(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
