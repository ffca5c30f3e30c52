"""PyTorch port: the 3D case (``cases/elastic3d.py``: banks, model jet,
loss, components and gradient of the main and MMS configurations, the
plane-wave oracle and ``mms_errors``) against the JAX package, f64 on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import elastic3d as j3
from pinn_elastodynamics_torch.cases import elastic3d as t3
from pinn_elastodynamics_torch.models.fields import FieldSpec, FIRST_ORDER
from pinn_elastodynamics_torch.ops.elasticity import ISOTROPIC_3D
from pinn_elastodynamics_torch.ops.jet import Jet
from pinn_elastodynamics_torch.ops.residuals import residuals
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.0005
REL = 1e-10
SPEC = FieldSpec(ndim=3, formulation=FIRST_ORDER)
# Bank sizes at scale 1.0 (JAX build_banks and build_mms).
FULL_SIZES = {
    "main": {"collocation": 225074, "src": 50000, "ic": 19983},
    "mms": {"collocation": 80000, "bc": 24000, "ic": 15000},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# name -> (JAX build function, port build function, widths)
CONFIGS = {
    "main": (j3.build, t3.build, [4] + [100] * 6 + [12]),
    "mms": (j3.build_mms, t3.build_mms, [4] + [64] * 5 + [12]),
}


@pytest.mark.parametrize("scale", [0.01, 1.0])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_banks_bitwise_equal_to_jax(name, scale):
    jbuild, tbuild, _ = CONFIGS[name]
    want = jbuild(scale=scale).banks
    got = tbuild(scale=scale, device="cpu").banks
    assert sorted(got) == sorted(want)
    for bank_name, bank in want.items():
        t = got[bank_name]
        assert t.xyt.dtype == torch.float32
        np.testing.assert_array_equal(t.xyt.numpy(), np.asarray(bank.xyt))
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(bank.mask))
        assert sorted(t.values) == sorted(bank.values)
        for k, v in bank.values.items():
            np.testing.assert_array_equal(t.values[k].numpy(), np.asarray(v))
    if scale == 1.0:
        assert {k: b.n_total for k, b in got.items()} == FULL_SIZES[name]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def cfg(request):
    jbuild, tbuild, dims = CONFIGS[request.param]
    host = _mlp(np.random.default_rng(sum(map(ord, request.param))), dims)
    jcase = jbuild(scale=SCALE, dtype=np.float64)
    tcase = tbuild(scale=SCALE, dtype=F64, device="cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    return dict(name=request.param, jcase=jcase, tcase=tcase, jparams=jparams,
                jmain=jax.jit(jax.value_and_grad(jcase.loss_and_aux_fn(),
                                                 has_aux=True))(jparams),
                tparams=tckpt.params_from_jax(host, device="cpu", dtype=F64))


def test_model_widths_and_routes(cfg):
    model = cfg["tcase"].model
    assert list(model.layers) == CONFIGS[cfg["name"]][2]
    assert model.normalize and model.jet_impl == "auto"
    assert model.lb == cfg["jcase"].model.lb
    assert model.ub == cfg["jcase"].model.ub


def test_model_jet_matches_jax(cfg):
    x = cfg["tcase"].banks["collocation"].xyt
    want = cfg["jcase"].model.jet(cfg["jparams"], jnp.asarray(x.numpy()))
    got = cfg["tcase"].model.jet(cfg["tparams"], x)
    assert want.dtt is None and got.dtt is None
    assert got.d.shape == (4, x.shape[0], 12)
    _close(got.f, want.f)
    _close(got.d, want.d)


@pytest.mark.parametrize("jet_impl", ["eager", "kernel"])
def test_main_loss_value_components_and_grad_match_jax(cfg, jet_impl):
    """Value, components and gradient of the main loss; "kernel" runs the
    fused autograd Functions with their plain versions on the CPU."""
    tcase = cfg["tcase"]
    tcase = dataclasses.replace(tcase, model=dataclasses.replace(
        tcase.model, jet_impl=jet_impl))
    (jv, jcomps), jg = cfg["jmain"]
    (tv, tcomps), tg = value_and_grad(tcase.loss_and_aux_fn(), cfg["tparams"],
                                      has_aux=True)
    _close(tv, jv)
    assert sorted(tcomps) == sorted(jcomps)
    for k in jcomps:
        _close(tcomps[k], jcomps[k])
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close(a, b)


def test_mms_errors_match_jax():
    rng = np.random.default_rng(5)
    host = _mlp(rng, [4] + [64] * 5 + [12])
    jcase = j3.build_mms(scale=SCALE)
    tcase = t3.build_mms(scale=SCALE, device="cpu")
    want = j3.mms_errors(jcase.model, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), host), n=500)
    got = t3.mms_errors(tcase.model, tckpt.params_from_jax(
        host, device="cpu", dtype=F64), n=500)
    assert sorted(got) == sorted(want) == sorted(SPEC.channels)
    for c in want:
        assert got[c] == pytest.approx(want[c], rel=REL, abs=REL)


# The four oracle tests of tests/test_mms3d.py on the port's plane wave.

def _points(n=512, seed=3):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, size=(n, 3))
    t = rng.uniform(0.0, 2.0, size=(n, 1))
    return np.concatenate([xyz, t], axis=1)


def _mms_jet(pts, **kw):
    return t3.mms_jet(pts, t3.MMS_MATERIAL, device="cpu", **kw)


def test_plane_wave_zeros_every_residual():
    pts = _points()
    jet = _mms_jet(pts)
    res = residuals(jet, SPEC, t3.MMS_MATERIAL, ISOTROPIC_3D)
    assert set(res) == {
        "f_u", "f_v", "f_w", "f_ut", "f_vt", "f_wt",
        "f_s11", "f_s22", "f_s33", "f_s12", "f_s13", "f_s23",
    }
    for name, r in res.items():
        assert float(r.abs().max()) < 1e-4, name
    want = j3.mms_jet(pts, j3.MMS_MATERIAL)
    np.testing.assert_array_equal(jet.f.numpy(), np.asarray(want.f))
    np.testing.assert_array_equal(jet.d.numpy(), np.asarray(want.d))


def test_perturbed_wave_is_detected():
    pts = _points(256)
    jet = _mms_jet(pts)
    bad = Jet(f=jet.f * 1.02, d=jet.d, dtt=None)  # 2% field perturbation
    res = residuals(bad, SPEC, t3.MMS_MATERIAL, ISOTROPIC_3D)
    assert max(float(r.abs().max()) for r in res.values()) > 1e-3


def test_wrong_wave_speed_breaks_momentum_only():
    pts = _points(256)
    mat_wrong = t3.Material(E=2.5, mu=0.25, rho=2.0)
    res = residuals(_mms_jet(pts), SPEC, mat_wrong, ISOTROPIC_3D)
    for name in ("f_s11", "f_s22", "f_s33", "f_s12", "f_s13", "f_s23",
                 "f_ut", "f_vt", "f_wt"):
        assert float(res[name].abs().max()) < 1e-4, name
    assert max(float(res[n].abs().max()) for n in ("f_u", "f_v", "f_w")) > 1e-2


def test_mms_fields_match_jet_values():
    pts = _points(128)
    fields = t3.mms_fields(pts, t3.MMS_MATERIAL)
    jet = _mms_jet(pts)
    for c in SPEC.channels:
        np.testing.assert_allclose(jet.f[:, SPEC.index(c)].numpy(), fields[c],
                                   atol=1e-6)
    want = j3.mms_fields(pts, j3.MMS_MATERIAL)
    for c in SPEC.channels:
        np.testing.assert_array_equal(fields[c], want[c])


@pytest.mark.parametrize("what", ["build", "build_mms", "mms_jet"])
def test_entry_points_default_to_the_gpu(monkeypatch, what):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"build": lambda: t3.build(scale=SCALE),
            "build_mms": lambda: t3.build_mms(scale=SCALE),
            "mms_jet": lambda: t3.mms_jet(_points(8), t3.MMS_MATERIAL)}[what]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        call()
