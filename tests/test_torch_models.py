"""PyTorch port: field models, checkpoints and rendering against the JAX
package, with the repo's plate checkpoints (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.eval import render as jrender
from pinn_elastodynamics_tpu.models import fields as jfields
from pinn_elastodynamics_tpu.models import fourier as jfourier
from pinn_elastodynamics_tpu.ops import residuals as jres
from pinn_elastodynamics_tpu.train import checkpoint as jckpt
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.eval import render as trender
from pinn_elastodynamics_torch.models import fields as tfields
from pinn_elastodynamics_torch.models import fourier as tfourier
from pinn_elastodynamics_torch.ops import residuals as tres
from pinn_elastodynamics_torch.ops.jet import Jet
from pinn_elastodynamics_torch.train import checkpoint as tckpt

F64 = torch.float64
CKPTS = {
    "net": ("runs/plate_v2/hybrid_best.ckpt", {}),
    "analytic": ("runs/plate_analytic/hybrid_best.ckpt",
                 dict(bc="analytic", fourier=64, fourier_scale=2.0)),
}


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module", params=sorted(CKPTS))
def plate(request):
    path, kw = CKPTS[request.param]
    host = tckpt.load_checkpoint(path)["params"]
    return dict(
        name=request.param,
        jmodel=jplate.build_model(**kw),
        jparams=_jax_tree(host),
        tmodel=tplate.build_model(**kw),
        tparams=tckpt.params_from_jax(host, device="cpu", dtype=F64),
    )


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 0.5, (n, 2)),
                           rng.uniform(0, 10, (n, 1))], 1)


def _assert_jet(tj, jj, tol):
    np.testing.assert_allclose(tj.f.numpy(), np.asarray(jj.f), rtol=0, atol=tol)
    np.testing.assert_allclose(tj.d.numpy(), np.asarray(jj.d), rtol=0, atol=tol)
    if jj.dtt is None:
        assert tj.dtt is None
    else:
        np.testing.assert_allclose(tj.dtt.numpy(), np.asarray(jj.dtt),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("order", [1, 2])
def test_plate_model_jet_matches_jax(plate, order):
    x = _points()
    want = plate["jmodel"].jet(plate["jparams"], jnp.asarray(x), order=order)
    got = plate["tmodel"].jet(plate["tparams"], torch.as_tensor(x), order=order)
    _assert_jet(got, want, 1e-10)


def test_plate_model_kernel_impl_on_cpu(plate):
    """jet_impl='kernel' on a CPU tensor runs the kernels' plain versions."""
    import dataclasses

    model = plate["tmodel"]
    if hasattr(model, "uv_model"):
        kmodel = dataclasses.replace(
            model, uv_model=dataclasses.replace(model.uv_model, jet_impl="kernel"))
    else:
        kmodel = dataclasses.replace(model, jet_impl="kernel")
    x = torch.as_tensor(_points(seed=1))
    got = kmodel.jet(plate["tparams"], x, order=2)
    want = model.jet(plate["tparams"], x, order=2)
    for name in ("f", "d", "dtt"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12)


def test_plate_apply_matches_jax(plate):
    x = _points(seed=2)
    want = plate["jmodel"].apply(plate["jparams"], jnp.asarray(x))
    got = plate["tmodel"].apply(plate["tparams"], torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def test_predict_fields_matches_jax(plate):
    xy = _points(n=250, seed=3)[:, :2]
    want = jrender.predict_fields(plate["jmodel"], plate["jparams"], xy, 2.5,
                                  chunk=128, dtype=np.float64)
    got = trender.predict_fields(plate["tmodel"], plate["tparams"], xy, 2.5,
                                 chunk=128, dtype=np.float64, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (250,)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10)
    frames = list(trender.predict_frames(plate["tmodel"], plate["tparams"], xy,
                                         [0.0, 2.5], chunk=128, dtype=np.float64,
                                         device="cpu"))
    assert [t for t, _ in frames] == [0.0, 2.5]
    np.testing.assert_array_equal(frames[1][1]["s11"], got["s11"])


def test_predict_fields_requires_gpu_unless_cpu(monkeypatch, plate):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trender.predict_fields(plate["tmodel"], plate["tparams"],
                               np.zeros((2, 2)), 0.0)


@pytest.mark.parametrize("order", [1, 2])
def test_fourier_and_normalized_models_match_jax(order):
    """Net-BC composite with a Fourier uv net, and a normalized plain MLP."""
    spec_j = jfields.FieldSpec(ndim=2, formulation=jfields.SECOND_ORDER)
    spec_t = tfields.FieldSpec(ndim=2, formulation=tfields.SECOND_ORDER)
    kw = dict(uv_hidden=(24, 24), dist_hidden=(8,), part_hidden=(8,),
              uv_fourier=8, uv_fourier_scale=2.0, normalize=True,
              lb=tplate.LB, ub=tplate.UB)
    jm = jfields.CompositeFieldModel(spec=spec_j, **kw)
    tm = tfields.CompositeFieldModel(spec=spec_t, jet_impl="auto", **kw)
    host = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.float64))
    x = _points(n=100, seed=4)
    _assert_jet(tm.jet(tckpt.params_from_jax(host, device="cpu", dtype=F64),
                       torch.as_tensor(x), order=order),
                jm.jet(_jax_tree(host), jnp.asarray(x), order=order), 1e-11)

    mkw = dict(hidden=(16, 16), normalize=True, lb=tplate.LB, ub=tplate.UB)
    jmlp_model = jfields.MLPFieldModel(spec=spec_j, **mkw)
    tmlp_model = tfields.MLPFieldModel(spec=spec_t, jet_impl="kernel", **mkw)
    host = jax.tree.map(np.asarray,
                        jmlp_model.init(jax.random.PRNGKey(1), jnp.float64))
    _assert_jet(tmlp_model.jet(tckpt.params_from_jax(host, device="cpu", dtype=F64),
                               torch.as_tensor(x), order=order),
                jmlp_model.jet(_jax_tree(host), jnp.asarray(x), order=order),
                1e-11)
    assert tmlp_model.layers == jmlp_model.layers


def test_fourier_embed_jet_matches_jax():
    spec = dict(ndim=2, formulation=jfields.SECOND_ORDER)
    kw = dict(hidden=(8,), n_features=6, feature_scale=2.0, normalize=True,
              lb=tplate.LB, ub=tplate.UB)
    jm = jfourier.FourierMLPFieldModel(spec=jfields.FieldSpec(**spec), **kw)
    tm = tfourier.FourierMLPFieldModel(spec=tfields.FieldSpec(**spec), **kw)
    host = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jnp.float64))
    x = _points(n=40, seed=5)
    want = jm._embed_jet(_jax_tree(host), jnp.asarray(x), 2)
    got = tm._embed_jet(tckpt.params_from_jax(host, device="cpu", dtype=F64),
                        torch.as_tensor(x), 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    assert tm.layers == jm.layers


def test_field_spec_and_jet_impl():
    for ndim in (2, 3):
        for form in (tfields.FIRST_ORDER, tfields.SECOND_ORDER):
            t = tfields.FieldSpec(ndim=ndim, formulation=form)
            j = jfields.FieldSpec(ndim=ndim, formulation=form)
            assert (t.channels, t.n_inputs, t.n_outputs, t.jet_order) == (
                j.channels, j.n_inputs, j.n_outputs, j.jet_order)
            assert t.index("u") == j.index("u")
    x = torch.zeros(2, 3)
    assert not tfields.use_kernel("auto", x)
    assert tfields.use_kernel("kernel", x)
    assert not tfields.use_kernel("eager", x)
    with pytest.raises(ValueError, match="jet_impl"):
        tfields.use_kernel("pallas", x)


def test_strains_2d_matches_jax():
    rng = np.random.default_rng(6)
    f, d = rng.standard_normal((9, 5)), rng.standard_normal((3, 9, 5))
    spec_t = tfields.FieldSpec(ndim=2, formulation=tfields.SECOND_ORDER)
    spec_j = jfields.FieldSpec(ndim=2, formulation=jfields.SECOND_ORDER)
    from pinn_elastodynamics_tpu.ops.jet import Jet as JJet

    got = tres.strains_2d(Jet(f=torch.as_tensor(f), d=torch.as_tensor(d)), spec_t)
    want = jres.strains_2d(JJet(f=jnp.asarray(f), d=jnp.asarray(d)), spec_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (tres.X, tres.Y, tres.T2D, tres.Z, tres.T3D) == (
        jres.X, jres.Y, jres.T2D, jres.Z, jres.T3D)


def test_checkpoint_loaders_match_jax():
    path = "runs/plate_v2/plate_hole_quarter_uv.pickle"
    want = jckpt.load_reference_pickle(path, jnp.float64)
    got = tckpt.load_reference_pickle(path, device="cpu", dtype=F64)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("W", "b"):
            assert g[k].dtype == F64
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))

    host = tckpt.load_checkpoint("runs/plate_v2/hybrid_best.ckpt", np.float64)
    ref = jckpt.load_checkpoint("runs/plate_v2/hybrid_best.ckpt", jnp.float64)
    assert host["params"]["uv"][0]["W"].dtype == np.float64
    assert host["iters"].dtype == np.asarray(ref["iters"]).dtype
    np.testing.assert_array_equal(host["params"]["dist"][2]["W"],
                                  np.asarray(ref["params"]["dist"][2]["W"]))
    params = tckpt.params_from_jax(host["params"], device="cpu")
    assert params["uv"][0]["W"].dtype == torch.float32
    assert params["uv"][0]["W"].shape == (3, 70)


def test_checkpoint_errors(tmp_path, monkeypatch):
    import pickle

    bad = tmp_path / "bad.pickle"
    with open(bad, "wb") as f:
        pickle.dump([[np.zeros((3, 4))], []], f)
    with pytest.raises(ValueError, match="malformed"):
        tckpt.load_reference_pickle(str(bad), device="cpu")
    with open(bad, "wb") as f:
        pickle.dump([[np.zeros((3, 4))], [np.zeros((1, 5))]], f)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_reference_pickle(str(bad), device="cpu")
    with pytest.raises(TypeError, match="not float"):
        tckpt.params_from_jax([{"W": np.zeros((2, 2), np.int32)}], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tckpt.params_from_jax([{"W": np.zeros((2, 2))}])
