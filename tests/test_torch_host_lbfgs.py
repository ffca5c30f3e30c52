"""PyTorch port: the extended-precision endgame (``ChunkSumCollector``, the
collector path through ``LossSpec``, ``train/lbfgs_host.py`` and
``cases/base.py::mixed_precision_phase_fn``) against the JAX package on the
CPU.  The host optimizer is numpy in both packages, so its histories and
carries are held bitwise; the device functions are f32 on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu import banks as jbanks
from pinn_elastodynamics_tpu.cases import base as jbase
from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.cases import wave_confined as jconf
from pinn_elastodynamics_tpu.train import lbfgs_host as jhost
from pinn_elastodynamics_torch import banks as tbanks
from pinn_elastodynamics_torch.cases import base as tbase
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.cases import wave_confined as tconf
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train import lbfgs_host as thost
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils.tree import tree_leaves
from pinn_elastodynamics_torch.utils.treepath import path_get

F32, F64 = torch.float32, torch.float64
SCALE = 0.05
LOSS_REL = 1e-5    # f32 value+grads summed in another order: relative loss
GRAD_REL = 1e-4    # and max|dg| / max(1, max|g|)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rosen_vg(x):
    f = np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    g = np.zeros_like(x)
    g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
    return f, g


A_QUAD = np.diag(np.linspace(1.0, 300.0, 40))


def _quad_vg(x):
    return 0.5 * x.dot(A_QUAD @ x), A_QUAD @ x


def test_rosenbrock_converges_to_machine_precision():
    res = thost.minimize_host(_rosen_vg, np.full(20, -1.2), maxiter=1500,
                              patience=50)
    assert isinstance(res, thost.HostLBFGSResult)
    assert res.final_loss < 1e-12
    # Healthy carried regime: ~1 eval per iteration, not a zoom storm.
    assert res.n_evals < 2.5 * res.n_iters


def test_carry_resume_continues_descent():
    r1 = thost.minimize_host(_quad_vg, np.ones(40), maxiter=8)
    r2 = thost.minimize_host(_quad_vg, r1.x, maxiter=300, init_carry=r1.carry)
    assert r2.final_loss < 1e-16
    r_full = thost.minimize_host(_quad_vg, np.ones(40), maxiter=400)
    assert r1.n_iters + r2.n_iters <= r_full.n_iters + 10


def _same_result(t, j):
    assert np.array_equal(t.x, j.x)
    assert t.final_loss == j.final_loss
    assert (t.n_iters, t.n_evals, t.converged) == (j.n_iters, j.n_evals,
                                                   j.converged)
    assert np.array_equal(t.loss_history, j.loss_history)
    for key in ("S", "Y", "R"):
        assert len(t.carry[key]) == len(j.carry[key])
        for a, b in zip(t.carry[key], j.carry[key]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("problem", ["rosenbrock", "carried_quadratic"])
def test_minimize_host_is_bitwise_jax(problem):
    """The numpy optimizer is a faithful copy: histories, evaluation counts,
    stops and curvature carries equal JAX's bit for bit."""
    if problem == "rosenbrock":
        kw = dict(maxiter=200, patience=50)
        t = thost.minimize_host(_rosen_vg, np.full(20, -1.2), **kw)
        j = jhost.minimize_host(_rosen_vg, np.full(20, -1.2), **kw)
        _same_result(t, j)
        return
    t1 = thost.minimize_host(_quad_vg, np.ones(40), maxiter=8)
    j1 = jhost.minimize_host(_quad_vg, np.ones(40), maxiter=8)
    _same_result(t1, j1)
    t2 = thost.minimize_host(_quad_vg, t1.x, maxiter=300, init_carry=t1.carry,
                             memory_size=5)
    j2 = jhost.minimize_host(_quad_vg, j1.x, maxiter=300, init_carry=j1.carry,
                             memory_size=5)
    _same_result(t2, j2)


@pytest.mark.parametrize("n, chunk", [(1024, 256), (1000, 512), (37, 8)])
def test_chunk_sum_collector_matches_jax(n, chunk):
    """Chunk sums (zero-padded to a multiple of the chunk) and counts of
    (N,) and (N, 1) residuals under a mask, f64, against JAX's."""
    rng = np.random.default_rng(n)
    r = rng.standard_normal(n)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float64)
    tcoll, jcoll = tbanks.ChunkSumCollector(chunk), jbanks.ChunkSumCollector(
        chunk)
    for name, res in (("a", r), ("b", r[:, None] * 3.0)):
        tcoll.add(name, torch.as_tensor(res), torch.as_tensor(mask))
        jcoll.add(name, jnp.asarray(res), jnp.asarray(mask))
    assert tcoll.names == jcoll.names == ["a", "b"]
    for t, j in zip(tcoll.arrays, jcoll.arrays, strict=True):
        assert t.dtype == F64 and t.shape == (-(-n // chunk),)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=0)
    for t, j in zip(tcoll.counts, jcoll.counts, strict=True):
        assert float(t) == float(j) == mask.sum()


def test_loss_spec_with_collector_is_unchanged():
    """A collector records one entry per masked square-and-mean and leaves
    the loss and components bitwise what they are without it."""
    case = tplate.build(scale=0.02, device="cpu")
    params = case.init_params(0)
    with torch.no_grad():
        plain, pcomps = case.loss.evaluate(case.model, params, case.material,
                                           case.banks)
        coll = tbanks.ChunkSumCollector(64)
        total, comps = case.loss.evaluate(case.model, params, case.material,
                                          case.banks, collector=coll)
    assert torch.equal(plain, total)
    assert all(torch.equal(pcomps[k], comps[k]) for k in pcomps)
    assert sorted(set(coll.names)) == sorted(comps)
    for name in comps:
        rebuilt = sum(float(a.double().sum()) / float(c) for nm, a, c in
                      zip(coll.names, coll.arrays, coll.counts) if nm == name)
        assert rebuilt == pytest.approx(float(comps[name]), rel=1e-5)


def _mlp(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


# name -> (build kwargs, trainable, parameter maker): the two plate main-path
# configurations at their real widths.
CONFIGS = {
    "net_bc": ({}, "uv", lambda r: {
        "uv": _mlp(r, [3] + [70] * 8 + [5]),
        "dist": _mlp(r, [3] + [20] * 4 + [5]),
        "part": _mlp(r, [3] + [20] * 4 + [5])}),
    "analytic_fourier64": (
        dict(bc="analytic", fourier=64, fourier_scale=2.0), "uv.mlp",
        lambda r: {"uv": {"B": 2.0 * r.standard_normal((3, 64)),
                          "mlp": _mlp(r, [128] + [70] * 8 + [5])}}),
}


def _plate(name, scale=SCALE):
    kw, trainable, make = CONFIGS[name]
    jcase = jplate.build(scale=scale, jet_impl="xla", **kw)
    tcase = tplate.build(scale=scale, device="cpu", **kw)
    jphase = dataclasses.replace(jcase.phases[-1], trainable=trainable)
    tphase = dataclasses.replace(tcase.phases[-1], trainable=trainable)
    host = make(np.random.default_rng(sum(map(ord, name))))
    return jcase, tcase, jphase, tphase, host


def _jax_tree(host, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), host)


def _grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= GRAD_REL * scale


def _host_vg_against_jax(jcase, tcase, jphase, tphase, jparams, tparams):
    jvg, jx0, _ = jhost.make_host_phase_vg(jcase, jphase, jparams)
    tvg, tx0, unravel = thost.make_host_phase_vg(tcase, tphase, tparams)
    assert tx0.dtype == np.float64 and np.array_equal(tx0, jx0)
    tf, tg = tvg(tx0)
    jf, jg = jvg(jx0)
    assert isinstance(tf, float) and tg.dtype == np.float64
    assert abs(tf - jf) <= LOSS_REL * abs(jf)
    _grad_close(tg, jg)
    return tvg, tx0, unravel


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_phase_vg_matches_jax(name):
    """x0 bitwise JAX's ravel_pytree vector (f64 parameters), the host f64
    loss and the f32 gradient against JAX's host_vg; the unravel maps x0
    back to the trainable subtree in f32; the packed device result holds
    the gradient, one chunk-sum array per entry and the counts."""
    jcase, tcase, jphase, tphase, host = _plate(name)
    tparams = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    tvg, x0, unravel = _host_vg_against_jax(
        jcase, tcase, jphase, tphase, _jax_tree(host, jnp.float64), tparams)
    sub = unravel(x0)
    want = path_get(tparams, tphase.trainable)
    for t, w in zip(tree_leaves(sub), tree_leaves(want), strict=True):
        assert t.dtype == F32 and torch.equal(t, w.to(F32))
    coll = tbanks.ChunkSumCollector(512)
    with torch.no_grad():
        tphase.loss.evaluate(tcase.model,
                             tckpt.params_from_jax(host, device="cpu"),
                             tcase.material, tcase.banks, collector=coll)
    packed = tvg.device(torch.as_tensor(x0, dtype=F32))
    assert packed.dtype == F32 and packed.shape == (
        x0.size + sum(a.numel() for a in coll.arrays) + len(coll.names),)
    f, g = tvg.host(packed.numpy())
    f_again, g_again = tvg(x0)
    assert f == f_again and np.array_equal(g, g_again)


CHECKPOINTS = {
    "runs/plate_analytic/hybrid_best.ckpt": (
        jplate, tplate, dict(bc="analytic", fourier=64, fourier_scale=2.0),
        "uv.mlp"),
    "runs/wave_confined_fourier/hybrid_best.ckpt": (
        jconf, tconf, dict(bc="hard", fourier=64), None),
}


@pytest.mark.parametrize("path", sorted(CHECKPOINTS))
def test_host_phase_vg_on_trained_checkpoints(path):
    """host_vg at the trained endgame parameters of the repo's hybrid
    checkpoints (plain numpy) against JAX's, and its loss against the
    float64 loss of the same parameters.  At an optimum the residuals are
    small differences of O(1) terms, so f32 rounding weighs more than at
    random weights: both packages' f32 losses sit within a few 1e-6 of the
    f64 loss at this scale."""
    jmod, tmod, kw, trainable = CHECKPOINTS[path]
    host = tckpt.load_checkpoint(path)["params"]
    jcase = jmod.build(scale=SCALE, jet_impl="xla", **kw)
    tcase = tmod.build(scale=SCALE, device="cpu", **kw)
    jphase = dataclasses.replace(jcase.phases[-1], trainable=trainable)
    tphase = dataclasses.replace(tcase.phases[-1], trainable=trainable)
    tvg, x0, _ = _host_vg_against_jax(
        jcase, tcase, jphase, tphase, _jax_tree(host, jnp.float32),
        tckpt.params_from_jax(host, device="cpu"))
    case64 = tmod.build(scale=SCALE, device="cpu", dtype=F64, **kw)
    fn, sub, _ = tbase._phase_loss_fn(
        case64, tphase, tckpt.params_from_jax(host, device="cpu", dtype=F64))
    with torch.no_grad():
        f64 = float(fn(sub))
    assert abs(tvg(x0)[0] - f64) <= LOSS_REL * abs(f64)


def test_chunk_sum_reconstruction_matches_f64_truth():
    """Host-f64 total from f32 chunk sums ≈ the true f64 loss (forward noise
    only), and the f32 loss of the same parameters."""
    case = tplate.build(scale=SCALE, pad_to_multiple_of=8, device="cpu")
    params = case.init_params(seed=3)
    phase = case.phases[-1]
    host_vg, x0, _ = thost.make_host_phase_vg(case, phase, params)
    f_host, g = host_vg(x0)
    assert g.dtype == np.float64 and g.shape == x0.shape
    assert np.all(np.isfinite(g))
    with torch.no_grad():
        f32_val = float(case.loss_fn(phase.loss, phase.scale)(params))
    assert abs(f_host - f32_val) / max(abs(f32_val), 1e-30) < 1e-5
    case64 = tplate.build(scale=SCALE, pad_to_multiple_of=8, dtype=F64,
                          device="cpu")
    params64 = {k: [{kk: vv.double() for kk, vv in layer.items()}
                    for layer in v] for k, v in params.items()}
    with torch.no_grad():
        f64_val = float(case64.loss_fn(phase.loss, phase.scale)(params64))
    assert abs(f_host - f64_val) / max(abs(f64_val), 1e-30) < 1e-4


def test_host_lbfgs_descends_on_plate_phase():
    case = tplate.build(scale=0.02, pad_to_multiple_of=8, device="cpu")
    params = case.init_params(seed=0)
    host_vg, x0, _ = thost.make_host_phase_vg(case, case.phases[-1], params)
    f0, _ = host_vg(x0)
    res = thost.minimize_host(host_vg, x0, maxiter=30, patience=50)
    assert res.final_loss < 0.9 * f0
    assert res.converged in ("maxiter", "ftol", "gtol", "target",
                             "linesearch")


def test_host_phase_vg_refuses_counts_beyond_float32():
    """Counts travel as float32: a bank of 2**24 points is refused before
    anything is evaluated."""
    case = tplate.build(scale=0.02, device="cpu")
    huge = torch.zeros(1, 3).expand(2 ** 24, 3)
    case.banks = dict(case.banks, collocation=tbanks.PointBank(
        huge, torch.zeros(1).expand(2 ** 24)))
    with pytest.raises(ValueError, match=r"2\*\*24"):
        thost.make_host_phase_vg(case, case.phases[-1], case.init_params(0))


def test_preconditioned_vg_fixes_anisotropy():
    """Jacobi preconditioning: a badly scaled quadratic that starves plain
    L-BFGS within a tight budget is solved immediately once whitened; the
    histories are JAX's bit for bit."""
    h = np.array([1e8, 1.0, 1e-0, 1e4, 1e2], np.float64)

    def vg(x):
        return 0.5 * float(h @ (x * x)), h * x

    x0 = np.ones_like(h)
    plain = thost.minimize_host(vg, x0, maxiter=3, patience=50)
    d = 1.0 / np.sqrt(h)  # exact whitening
    vg_u, to_u, from_u = thost.make_preconditioned_vg(vg, d)
    pre = thost.minimize_host(vg_u, to_u(x0), maxiter=3, patience=50)
    x_back = from_u(pre.x)
    assert pre.final_loss < 1e-12 * max(plain.final_loss, 1e-30) or (
        pre.final_loss < 1e-10)
    assert np.abs(x_back).max() < 1e-5
    np.testing.assert_allclose(from_u(to_u(x0)), x0, rtol=1e-12)
    jvg_u, jto_u, _ = jhost.make_preconditioned_vg(vg, d)
    _same_result(pre, jhost.minimize_host(jvg_u, jto_u(x0), maxiter=3,
                                          patience=50))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mixed_precision_phase_fn_matches_jax(name):
    """Value+grad over f64 parameters with f32 compute: the loss within
    1e-5 relative and the gradient within 1e-4 scaled of JAX's (x64 on,
    f32 compute on both sides), float64 loss and gradients, and ``merge``
    leaves the frozen leaves untouched."""
    jcase, tcase, jphase, tphase, host = _plate(name)
    jparams = _jax_tree(host, jnp.float64)
    tparams = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    jfn, jsub, _ = jbase.mixed_precision_phase_fn(jcase, jphase, jparams)
    tfn, tsub, merge = tbase.mixed_precision_phase_fn(tcase, tphase, tparams)
    jloss, jgrad = jax.value_and_grad(jfn)(jsub)
    tloss, tgrad = value_and_grad(tfn, tsub)
    assert tloss.dtype == F64
    assert all(g.dtype == F64 for g in tree_leaves(tgrad))
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    for t, j in zip(tree_leaves(tgrad), jax.tree.leaves(jgrad), strict=True):
        _grad_close(t.numpy(), j)
    new_sub = [{k: v - 1.0 for k, v in layer.items()} for layer in tsub]
    merged = merge(tparams, new_sub)
    assert path_get(merged, tphase.trainable) is new_sub
    frozen = ("dist", "part") if name == "net_bc" else ("B",)
    for key in frozen:
        src = tparams[key] if name == "net_bc" else tparams["uv"][key]
        out = merged[key] if name == "net_bc" else merged["uv"][key]
        for a, b in zip(tree_leaves(out), tree_leaves(src), strict=True):
            assert a is b and a.dtype == F64
