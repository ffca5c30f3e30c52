"""PyTorch port: the inverse problem (``cases/inverse.py``) and its host
engine (``train/lbfgs_host.py::make_host_problem_vg``) against the JAX
package on the CPU.  The sensor frames are synthetic ``.mat`` files of a
plane P-wave that solves the confined case's plane-strain equations at the
true E = 2.5, rho = 1, nu = 0.25; JAX's ``inverse.build`` reads them through a
``monkeypatch`` of ``wave_confined.FEM_DIR``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
from jax.flatten_util import ravel_pytree

from pinn_elastodynamics_tpu.cases import inverse as jinv
from pinn_elastodynamics_tpu.cases import wave_confined as jconf
from pinn_elastodynamics_tpu.train import lbfgs_host as jhost
from pinn_elastodynamics_torch.banks import make_bank
from pinn_elastodynamics_torch.cases import inverse as tinv
from pinn_elastodynamics_torch.models.fields import FieldSpec, SECOND_ORDER
from pinn_elastodynamics_torch.ops.elasticity import (
    Material,
    PLANE_STRESS,
    plane_stress_stress,
)
from pinn_elastodynamics_torch.ops.jet import Jet
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train import lbfgs_host as thost
from pinn_elastodynamics_torch.train.lbfgs import minimize
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F32, F64 = torch.float32, torch.float64
REL = 1e-10        # float64 parity
LOSS_REL = 1e-5    # f32 on both sides
AMP, WAVENUMBER, C_P = 0.01, 0.5, np.sqrt(3.0)
BUILD = dict(scale=0.002, n_sensor_frames=3, sensors_per_frame=30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plane_p_wave(x, t):
    """u = A·sin(k(x − c_p·t)), v = 0 with lambda = G = 1, c_p² = 3:
    s11 = 3Ak·cos, s22 = Ak·cos, s12 = 0."""
    ph = WAVENUMBER * (x - C_P * t)
    c = AMP * WAVENUMBER * np.cos(ph)
    zero = np.zeros_like(x)
    return {"u": AMP * np.sin(ph), "v": zero, "s11": 3.0 * c, "s22": c,
            "s12": zero}


@pytest.fixture(scope="module")
def fem_dir(tmp_path_factory):
    """Frames 0-56 of the plane wave at 400 probe points (FEM coordinates,
    the PINN's shifted by +15)."""
    out = str(tmp_path_factory.mktemp("fem"))
    xy = np.random.default_rng(21).uniform(0.0, 30.0, (400, 2))
    for i in range(57):
        f = plane_p_wave(xy[:, 0] - 15.0, i * 14.0 / 56)
        data = {"x": xy[:, :1], "y": xy[:, 1:]}
        data.update({k: v[:, None] for k, v in f.items()})
        scipy.io.savemat(os.path.join(out, f"ProbeData-{i}.mat"), data)
    return out


def _builds(fem_dir, monkeypatch, dtype, **kw):
    monkeypatch.setattr(jconf, "FEM_DIR", fem_dir)
    jprob, jbanks = jinv.build(dtype=np.dtype(dtype), **BUILD, **kw)
    tprob, tbanks = tinv.build(dtype=F64 if dtype == "float64" else F32,
                               fem_dir=fem_dir, device="cpu", **BUILD, **kw)
    return jprob, jbanks, tprob, tbanks


@pytest.mark.parametrize("accel", [False, True])
def test_sensors_and_banks_are_bitwise_jax(fem_dir, monkeypatch, accel):
    kw = dict(accel_weight=2.0, pad_to_multiple_of=8) if accel else {}
    frames = np.array([2, 28, 55] if accel else [1, 28, 56])
    args = (fem_dir, frames, lambda f: f * 14.0 / 56)
    opts = dict(n_per_frame=12, offset=(-15.0, -15.0), seed=4, accel=accel)
    for t, j in zip(tinv.sensors_from_fem(*args, **opts),
                    jinv.sensors_from_fem(*args, **opts), strict=True):
        assert np.array_equal(t, j)
    for dtype in ("float32", "float64"):
        jprob, jbanks, tprob, tbanks = _builds(fem_dir, monkeypatch, dtype,
                                               **kw)
        assert tprob.weights == jprob.weights
        assert (tprob.mu, tprob.E_init, tprob.rho_init, tprob.plane) == (
            jprob.mu, jprob.E_init, jprob.rho_init, jprob.plane)
        assert tprob.model.layers == jprob.model.layers
        assert sorted(tbanks) == sorted(jbanks)
        for name, jb in jbanks.items():
            tb = tbanks[name]
            assert sorted(tb.values) == sorted(jb.values)
            for t, j in [(tb.xyt, jb.xyt), (tb.mask, jb.mask)] + [
                    (tb.values[k], jb.values[k]) for k in jb.values]:
                assert str(t.dtype) == f"torch.{dtype}"
                assert np.array_equal(t.numpy(), np.asarray(j))
    assert ("att" in tbanks["sensors"].values) == accel


def _host_params(prob, seed):
    rng = np.random.default_rng(seed)
    dims = prob.model.layers
    net = [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
            "b": 0.1 * rng.standard_normal(o)}
           for i, o in zip(dims[:-1], dims[1:])]
    return {"net": net, "log_E": np.log(1.7), "log_rho": np.log(0.8)}


@pytest.mark.parametrize("jet_impl", ["auto", "kernel"])
@pytest.mark.parametrize("accel", [False, True])
def test_loss_components_and_gradients_match_jax(fem_dir, monkeypatch, accel,
                                                 jet_impl):
    """Every component (E and rho too) and the gradient of every leaf,
    ``log_E`` and ``log_rho`` included, in float64 within 1e-10; the
    ``kernel`` route runs the fused Functions' plain versions (order 2 on
    the acceleration sensors)."""
    kw = dict(accel_weight=2.0) if accel else {}
    jprob, jbanks, _, _ = _builds(fem_dir, monkeypatch, "float64", **kw)
    tprob, tbanks = tinv.build(dtype=F64, fem_dir=fem_dir, device="cpu",
                               jet_impl=jet_impl, **BUILD, **kw)
    host = _host_params(tprob, 5)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    tparams = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    jtotal, jcomps = jprob.loss_and_aux(jparams, jbanks)
    ttotal, tcomps = tprob.loss_and_aux(tparams, tbanks)
    assert sorted(tcomps) == sorted(jcomps)
    assert ("DATA_TT" in tcomps) == accel
    for k in jcomps:
        assert float(tcomps[k]) == pytest.approx(float(jcomps[k]), rel=REL)
    assert float(ttotal) == pytest.approx(float(jtotal), rel=REL)

    jgrad = jax.grad(jprob.loss_fn(jbanks))(jparams)
    loss, tgrad = value_and_grad(tprob.loss_fn(tbanks), tparams)
    assert float(loss) == pytest.approx(float(jtotal), rel=REL)
    for t, j in zip(tree_leaves(tgrad), jax.tree.leaves(jgrad), strict=True):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == F64
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=REL * max(1.0, np.abs(j).max()))
    assert abs(float(tgrad["log_E"])) > 0 and abs(float(tgrad["log_rho"])) > 0


def test_init_params(fem_dir):
    prob, _ = tinv.build(fem_dir=fem_dir, device="cpu", **BUILD)
    p = prob.init_params(seed=3)
    assert sorted(p) == ["log_E", "log_rho", "net"]
    assert float(torch.exp(p["log_E"])) == pytest.approx(1.0)
    assert float(torch.exp(p["log_rho"])) == pytest.approx(0.5)
    again = prob.init_params(seed=3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    assert [tuple(l["W"].shape) for l in p["net"]] == (
        [(3, 140)] + [(140, 140)] * 5 + [(140, 7)])
    mat = prob.material(p)
    assert isinstance(mat.E, torch.Tensor) and mat.mu == 0.25


class _AnalyticPlaneStressModel:
    """Manufactured plane-stress field whose stresses satisfy the
    constitutive law at E_TRUE exactly (tests/test_extensions.py's model,
    in torch): the f_s residual as a function of E vanishes at E_TRUE."""

    E_TRUE = 20.0
    RHO_TRUE = 1.3
    MU = 0.25
    spec = FieldSpec(ndim=2, formulation=SECOND_ORDER)

    def init(self, generator, dtype=F64, device="cpu"):
        return {}

    def apply(self, params, xyt):
        return self.jet(params, xyt).f

    def jet(self, params, xyt, order=None):
        mat = Material(E=self.E_TRUE, mu=self.MU, rho=self.RHO_TRUE)
        x, y, t = xyt[:, 0], xyt[:, 1], xyt[:, 2]
        u = x**2 + y * t**2
        v = x * y * t
        e11, e22, e12 = 2 * x, x * t, t**2 + y * t
        s11, s22, s12 = plane_stress_stress(mat, e11, e22, e12)
        zeros = torch.zeros_like(x)
        du = (2 * x, t**2, 2 * y * t)
        dv = (y * t, x * t, x * y)
        de11 = (2 + zeros, zeros, zeros)
        de22 = (t, zeros, x)
        de12 = (zeros, t, 2 * t + y)
        ds = [plane_stress_stress(mat, de11[i], de22[i], de12[i])
              for i in range(3)]
        f = torch.stack([u, v, s11, s22, s12], dim=1)
        d = torch.stack(
            [torch.stack([du[i], dv[i], ds[i][0], ds[i][1], ds[i][2]], dim=1)
             for i in range(3)], dim=0)
        dtt = torch.stack([2 * y, zeros, zeros, zeros, zeros], dim=1)
        return Jet(f=f, d=d, dtt=dtt)


def test_inverse_recovers_youngs_modulus():
    """With fields fixed at a manufactured solution, the port's L-BFGS on
    the constitutive residual over log E recovers E_true (the analogue of
    tests/test_extensions.py::test_inverse_recovers_youngs_modulus)."""
    model = _AnalyticPlaneStressModel()
    prob = tinv.InverseProblem(name="analytic", model=model,
                               plane=PLANE_STRESS, mu=model.MU, E_init=5.0,
                               rho_init=1.0, weights=(("f_s", 1.0),),
                               device="cpu")
    pts = np.random.default_rng(0).uniform(0.2, 1.0, (500, 3))
    obs = model.jet({}, torch.as_tensor(pts[:50])).f[:, :2].numpy()
    banks = {"collocation": make_bank(pts, dtype=F64, device="cpu"),
             "sensors": make_bank(pts[:50], {"uv": obs}, dtype=F64,
                                  device="cpu")}
    params = prob.init_params(seed=0, dtype=F64)
    assert params["net"] == {}

    def loss(mp):
        return prob.loss_fn(banks)({**params, **mp})

    res = minimize(loss, {"log_E": params["log_E"],
                          "log_rho": params["log_rho"]}, maxiter=200)
    assert float(torch.exp(res.params["log_E"])) == pytest.approx(
        model.E_TRUE, rel=1e-4)


def test_host_problem_vg_matches_jax(fem_dir, monkeypatch):
    """``x0`` bitwise JAX's ``ravel_pytree`` vector (log_E, log_rho, then
    the net); the host float64 loss of the f32 device value+grad within
    1e-5 of JAX's and the gradient within 1e-4 scaled; 5 host L-BFGS
    iterations over each package's value+grad follow the same history to
    f32 noise and descend."""
    jprob, jbanks, tprob, tbanks = _builds(fem_dir, monkeypatch, "float32",
                                           accel_weight=2.0)
    host = _host_params(tprob, 9)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    tparams = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    jvg, jx0, _ = jhost.make_host_problem_vg(jprob, jbanks, jparams)
    tvg, tx0, unravel = thost.make_host_problem_vg(tprob, tbanks, tparams)
    assert tx0.dtype == np.float64 and np.array_equal(tx0, jx0)
    assert np.array_equal(tx0, np.asarray(ravel_pytree(jparams)[0]))
    assert tx0[0] == np.log(1.7) and tx0[1] == np.log(0.8)
    sub = unravel(tx0)
    assert sub["log_E"].shape == () and sub["log_E"].dtype == F32
    tf, tg = tvg(tx0)
    jf, jg = jvg(jx0)
    assert isinstance(tf, float) and tg.dtype == np.float64
    assert abs(tf - jf) <= LOSS_REL * abs(jf)
    assert np.abs(tg - jg).max() <= 1e-4 * max(1.0, np.abs(jg).max())

    tres = thost.minimize_host(tvg, tx0, maxiter=5, memory_size=10)
    jres = jhost.minimize_host(jvg, jx0, maxiter=5, memory_size=10)
    assert tres.n_iters == jres.n_iters == 5
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=1e-4)
    assert tres.final_loss < tres.loss_history[0]
