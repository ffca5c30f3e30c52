"""PyTorch port: the quarter-plate case (banks, losses, phases, gradients)
against the JAX package, f64 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import base as jbase
from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_torch.cases import base as tbase
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.02
REL = 1e-10


def _plain_analytic_params():
    """Numpy-seeded uv net 3→8×70→5 for the analytic plain-MLP case."""
    rng = np.random.default_rng(5)
    dims = [3] + [70] * 8 + [5]
    return {"uv": [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
                    "b": 0.1 * rng.standard_normal(o)}
                   for i, o in zip(dims[:-1], dims[1:])]}


# name -> (build kwargs, parameters as a numpy tree, trainable path)
CONFIGS = {
    "net_bc": (dict(), "runs/plate_v2/hybrid_best.ckpt", "uv"),
    "analytic_fourier64": (dict(bc="analytic", fourier=64, fourier_scale=2.0),
                           "runs/plate_analytic/hybrid_best.ckpt", "uv.mlp"),
    "analytic_plain": (dict(bc="analytic"), None, "uv"),
}


def _host_params(src):
    if src is None:
        return _plain_analytic_params()
    return tckpt.load_checkpoint(src, np.float64)["params"]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def cfg(request):
    kw, src, trainable = CONFIGS[request.param]
    host = _host_params(src)
    jcase = jplate.build(scale=SCALE, dtype=np.float64, **kw)
    tcase = tplate.build(scale=SCALE, dtype=F64, device="cpu", **kw)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    return dict(name=request.param, host=host, trainable=trainable,
                jcase=jcase, tcase=tcase, jparams=jparams,
                jmain=jax.jit(jax.value_and_grad(jcase.loss_and_aux_fn(),
                                                 has_aux=True))(jparams),
                tparams=tckpt.params_from_jax(host, device="cpu", dtype=F64))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_build_banks_bitwise_equal_to_jax(scale):
    want = jplate.build_banks(seed=1111, scale=scale)
    got = tplate.build_banks(seed=1111, scale=scale, device="cpu")
    assert sorted(got) == sorted(want)
    for name, bank in want.items():
        t = got[name]
        assert t.xyt.dtype == torch.float32
        np.testing.assert_array_equal(t.xyt.numpy(), np.asarray(bank.xyt))
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(bank.mask))
        assert sorted(t.values) == sorted(bank.values)
        for k, v in bank.values.items():
            np.testing.assert_array_equal(t.values[k].numpy(), np.asarray(v))
    if scale == 1.0:
        sizes = {k: b.n_total for k, b in got.items()}
        assert sizes == {"collocation": 103711, "hole": 9960, "ic": 4844,
                         "lf": 8000, "rt": 13000, "up": 8000, "lw": 8000,
                         "dist": 9786}


def test_padded_banks_keep_the_loss():
    params = tckpt.params_from_jax(_plain_analytic_params(), device="cpu",
                                   dtype=F64)
    plain = tplate.build(scale=SCALE, dtype=F64, device="cpu", bc="analytic")
    padded = tplate.build(scale=SCALE, dtype=F64, device="cpu",
                          pad_to_multiple_of=64, bc="analytic")
    assert all(b.n_total % 64 == 0 for b in padded.banks.values())
    a = plain.loss_fn(plain.loss)(params)
    b = padded.loss_fn(padded.loss)(params)
    _close(b, a, 1e-13)


@pytest.mark.parametrize("jet_impl", ["eager", "kernel"])
def test_main_loss_value_components_and_grad_match_jax(cfg, jet_impl):
    """Value, components and gradient of the main loss; "kernel" runs the
    fused autograd Functions with their plain versions on the CPU."""
    tcase = cfg["tcase"]
    if jet_impl == "kernel":
        model = tcase.model
        if hasattr(model, "uv_model"):
            model = dataclasses.replace(model, uv_model=dataclasses.replace(
                model.uv_model, jet_impl="kernel"))
        else:
            model = dataclasses.replace(model, jet_impl="kernel")
        tcase = dataclasses.replace(tcase, model=model)
    (jv, jcomps), jg = cfg["jmain"]
    (tv, tcomps), tg = value_and_grad(tcase.loss_and_aux_fn(), cfg["tparams"],
                                      has_aux=True)
    _close(tv, jv)
    assert sorted(tcomps) == sorted(jcomps) == ["HOLE", "f_s", "f_uv"]
    for k in jcomps:
        _close(tcomps[k], jcomps[k])
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close(a, b)
    assert tcase.components(cfg["tparams"]).keys() == jcomps.keys()


def test_phase_losses_match_jax(cfg):
    """Every phase's loss over its trainable subtree (``uv.mlp`` leaves the
    Fourier matrix ``B`` frozen), value and gradient."""
    jcase, tcase = cfg["jcase"], cfg["tcase"]
    assert [p.name for p in tcase.phases] == [p.name for p in jcase.phases]
    for jphase, tphase in zip(jcase.phases, tcase.phases):
        if tphase.name == "uv":
            jphase = dataclasses.replace(jphase, trainable=cfg["trainable"])
            tphase = dataclasses.replace(tphase, trainable=cfg["trainable"])
        jfn, jsub, _ = jbase._phase_loss_fn(jcase, jphase, cfg["jparams"])
        tfn, tsub, merge = tbase._phase_loss_fn(tcase, tphase, cfg["tparams"])
        jv, jg = jax.jit(jax.value_and_grad(jfn))(jsub)
        tv, tg = value_and_grad(tfn, tsub)
        _close(tv, jv)
        jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            _close(a, b)
        merged = merge(cfg["tparams"], tsub)
        if cfg["trainable"] == "uv.mlp":
            assert merged["uv"]["B"] is cfg["tparams"]["uv"]["B"]


def test_case_surface_matches_jax():
    jcase = jplate.build(scale=SCALE)
    tcase = tplate.build(scale=SCALE, device="cpu")
    np.testing.assert_array_equal(tplate.eval_grid(), jplate.eval_grid())
    assert (tcase.material.E, tcase.material.mu, tcase.material.rho) == (
        jcase.material.E, jcase.material.mu, jcase.material.rho)
    assert (tcase.name, tcase.plane, tcase.lb, tcase.ub) == (
        jcase.name, jcase.plane, jcase.lb, jcase.ub)
    for jp, tp in zip(jcase.phases, tcase.phases):
        assert (tp.name, tp.trainable, tp.scale, tp.maxiter, tp.ftol) == (
            jp.name, jp.trainable, jp.scale, jp.maxiter, jp.ftol)
        assert tp.loss.weights == jp.loss.weights
    params = tcase.init_params(0)
    want = jcase.init_params(0)
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(a.shape) for a in jax.tree.leaves(want)]
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))


def test_build_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tplate.build(scale=SCALE)
