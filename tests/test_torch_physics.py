"""PyTorch port: elasticity, residuals, traction, banks and losses against
the JAX package on the same jets (f64), plus the manufactured-solution
checks of tests/test_residuals.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu import banks as jbanks
from pinn_elastodynamics_tpu.models import fields as jfields
from pinn_elastodynamics_tpu.ops import elasticity as jel
from pinn_elastodynamics_tpu.ops import residuals as jres
from pinn_elastodynamics_tpu.ops import traction as jtrac
from pinn_elastodynamics_tpu.ops.jet import Jet as JJet
from pinn_elastodynamics_torch import banks as tbanks
from pinn_elastodynamics_torch.models import fields as tfields
from pinn_elastodynamics_torch.models.mlp import mlp_apply
from pinn_elastodynamics_torch.ops import elasticity as tel
from pinn_elastodynamics_torch.ops import residuals as tres
from pinn_elastodynamics_torch.ops import traction as ttrac
from pinn_elastodynamics_torch.ops.jet import Jet

F64 = torch.float64
TOL = 1e-12
MAT = dict(E=20.0, mu=0.25, rho=1.3)
FORMS = [(2, "second_order"), (2, "first_order"), (3, "second_order"),
         (3, "first_order")]


def _specs(ndim, form):
    return (tfields.FieldSpec(ndim=ndim, formulation=form),
            jfields.FieldSpec(ndim=ndim, formulation=form))


def _random_jet(rng, spec, n=40):
    f = rng.standard_normal((n, spec.n_outputs))
    d = rng.standard_normal((spec.n_inputs, n, spec.n_outputs))
    dtt = rng.standard_normal((n, spec.n_outputs))
    return (Jet(f=torch.as_tensor(f), d=torch.as_tensor(d),
                dtt=torch.as_tensor(dtt)),
            JJet(f=jnp.asarray(f), d=jnp.asarray(d), dtt=jnp.asarray(dtt)))


@pytest.mark.parametrize("ndim,form", FORMS)
def test_residuals_match_jax_on_the_same_jet(ndim, form):
    rng = np.random.default_rng(ndim * 10 + len(form))
    tspec, jspec = _specs(ndim, form)
    tjet, jjet = _random_jet(rng, tspec)
    planes = ((tel.PLANE_STRESS, jel.PLANE_STRESS),
              (tel.PLANE_STRAIN, jel.PLANE_STRAIN)) if ndim == 2 else (
                  (tel.ISOTROPIC_3D, jel.ISOTROPIC_3D),)
    for tplane, jplane in planes:
        got = tres.residuals(tjet, tspec, tel.Material(**MAT), tplane)
        want = jres.residuals(jjet, jspec, jel.Material(**MAT), jplane)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=TOL)
    assert tres.momentum_group(tspec) == jres.momentum_group(jspec)
    assert tres.stress_group(tspec) == jres.stress_group(jspec)


def test_unknown_plane_and_material_constants():
    tspec, _ = _specs(2, "second_order")
    tjet, _ = _random_jet(np.random.default_rng(0), tspec)
    with pytest.raises(ValueError, match="plane"):
        tres.residuals_2d(tjet, tspec, tel.Material(**MAT), "plane_wave")
    t, j = tel.Material(**MAT), jel.Material(**MAT)
    assert t.lame_lambda == j.lame_lambda
    assert t.shear_modulus == j.shear_modulus
    e = np.random.default_rng(1).standard_normal((6, 7))
    for tf, jf, k in ((tel.plane_stress_stress, jel.plane_stress_stress, 3),
                      (tel.plane_strain_stress, jel.plane_strain_stress, 3),
                      (tel.isotropic_3d_stress, jel.isotropic_3d_stress, 6)):
        got = tf(t, *torch.as_tensor(e[:k]))
        want = jf(j, *jnp.asarray(e[:k]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _manufactured_jet(xyt, plane, mat):
    """u = x² + y·t², v = x·y·t, stresses from the constitutive law, as
    tests/test_residuals.py builds it."""
    x, y, t = xyt[:, 0], xyt[:, 1], xyt[:, 2]
    fn = (tel.plane_stress_stress if plane == tel.PLANE_STRESS
          else tel.plane_strain_stress)
    s11, s22, s12 = fn(mat, 2 * x, x * t, t**2 + y * t)
    zeros = torch.zeros_like(x)
    du = (2 * x, t**2, 2 * y * t)
    dv = (y * t, x * t, x * y)
    de11 = (2 + zeros, zeros, zeros)
    de22 = (t, zeros, x)
    de12 = (zeros, t, 2 * t + y)
    ds = [fn(mat, de11[i], de22[i], de12[i]) for i in range(3)]
    u_tt, v_tt = 2 * y, zeros
    f = torch.stack([x**2 + y * t**2, x * y * t, s11, s22, s12], 1)
    d = torch.stack([torch.stack([du[i], dv[i], *ds[i]], 1) for i in range(3)])
    dtt = torch.stack([u_tt, v_tt, zeros, zeros, zeros], 1)
    f_u = ds[0][0] + ds[1][2] - mat.rho * u_tt
    f_v = ds[1][1] + ds[0][2] - mat.rho * v_tt
    return Jet(f=f, d=d, dtt=dtt), f_u, f_v


@pytest.mark.parametrize("plane", [tel.PLANE_STRESS, tel.PLANE_STRAIN])
def test_manufactured_solution_2d(plane):
    xyt = torch.as_tensor(np.random.default_rng(2).uniform(size=(50, 3)))
    mat = tel.Material(**MAT)
    spec, _ = _specs(2, "second_order")
    jet, f_u, f_v = _manufactured_jet(xyt, plane, mat)
    res = tres.residuals(jet, spec, mat, plane)
    for k in ("f_s11", "f_s22", "f_s12"):
        torch.testing.assert_close(res[k], torch.zeros_like(res[k]), rtol=0,
                                   atol=TOL)
    torch.testing.assert_close(res["f_u"], f_u, rtol=0, atol=TOL)
    torch.testing.assert_close(res["f_v"], f_v, rtol=0, atol=TOL)


@pytest.mark.parametrize("plane", [tel.PLANE_STRESS, tel.PLANE_STRAIN])
def test_residuals_match_nested_autodiff(plane):
    """Residuals of an MLP's jet equal those from nested per-point autodiff
    of its plain forward, the reference's way."""
    rng = np.random.default_rng(3)
    spec, _ = _specs(2, "second_order")
    model = tfields.MLPFieldModel(spec=spec, hidden=(16, 16))
    params = model.init(torch.Generator().manual_seed(1), F64, "cpu")
    xyt = torch.as_tensor(rng.uniform(size=(7, 3)))
    mat = tel.Material(**MAT)
    res = tres.residuals(model.jet(params, xyt), spec, mat, plane)

    def f_single(p):
        return mlp_apply(params, p[None])[0]

    jac = torch.stack([torch.autograd.functional.jacobian(f_single, p)
                       for p in xyt])                       # (N, 5, 3)
    hess = torch.stack([torch.stack([
        torch.autograd.functional.hessian(lambda q: f_single(q)[c], p)
        for c in range(2)]) for p in xyt])                  # (N, 2, 3, 3)
    out = mlp_apply(params, xyt)
    fn = (tel.plane_stress_stress if plane == tel.PLANE_STRESS
          else tel.plane_strain_stress)
    sp = fn(mat, jac[:, 0, 0], jac[:, 1, 1], jac[:, 0, 1] + jac[:, 1, 0])
    for k, i, s in (("f_s11", 2, sp[0]), ("f_s22", 3, sp[1]),
                    ("f_s12", 4, sp[2])):
        torch.testing.assert_close(res[k], out[:, i] - s, rtol=0, atol=TOL)
    torch.testing.assert_close(
        res["f_u"], jac[:, 2, 0] + jac[:, 4, 1] - mat.rho * hess[:, 0, 2, 2],
        rtol=0, atol=1e-11)
    torch.testing.assert_close(
        res["f_v"], jac[:, 3, 1] + jac[:, 4, 0] - mat.rho * hess[:, 1, 2, 2],
        rtol=0, atol=1e-11)


@pytest.mark.parametrize("ndim", [2, 3])
def test_traction_matches_jax(ndim):
    rng = np.random.default_rng(4 + ndim)
    tspec, jspec = _specs(ndim, "second_order")
    fields = rng.standard_normal((30, tspec.n_outputs))
    normals = rng.standard_normal((ndim, 30))
    tf = ttrac.traction_2d if ndim == 2 else ttrac.traction_3d
    jf = jtrac.traction_2d if ndim == 2 else jtrac.traction_3d
    got = tf(torch.as_tensor(fields), tspec, *torch.as_tensor(normals))
    want = jf(jnp.asarray(fields), jspec, *jnp.asarray(normals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    xy = rng.uniform(size=(2, 20))
    for g, w in zip(ttrac.circle_normals(*torch.as_tensor(xy), r=0.1),
                    jtrac.circle_normals(*jnp.asarray(xy), r=0.1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_bank_and_masked_mean_square_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((13, 3))
    vals = {"t": rng.standard_normal(13), "n": rng.standard_normal((13, 2))}
    want = jbanks.make_bank(pts, vals, dtype=jnp.float64, pad_to_multiple_of=8)
    got = tbanks.make_bank(pts, vals, dtype=F64, pad_to_multiple_of=8,
                           device="cpu")
    assert got.n_total == want.n_total == 16
    np.testing.assert_array_equal(got.xyt.numpy(), np.asarray(want.xyt))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for k in vals:
        np.testing.assert_array_equal(got.values[k].numpy(),
                                      np.asarray(want.values[k]))
    r = rng.standard_normal(16)
    for dtype, jdtype in ((None, None), (F64, jnp.float64)):
        g = tbanks.masked_mean_square(torch.as_tensor(r, dtype=torch.float32),
                                      got.mask.float(), dtype)
        w = jbanks.masked_mean_square(jnp.asarray(r, jnp.float32),
                                      jnp.asarray(want.mask, jnp.float32),
                                      jdtype)
        assert g.dtype == (dtype or torch.float32)
        np.testing.assert_allclose(float(g), float(w), rtol=1e-7)
    assert tbanks.bank_sizes({"a": got}) == {"a": 16}
