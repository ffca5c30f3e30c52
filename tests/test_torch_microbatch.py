"""PyTorch port: the microbatched loss (``train/step.py::
make_microbatched_loss_fn``) against the port's full-batch loss and the JAX
package's microbatched loss, f64 on the CPU, as
``tests/test_sharding.py::test_microbatched_loss_matches_full`` holds the
JAX one (without a mesh)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import wave_confined as jconf
from pinn_elastodynamics_tpu.train.step import (
    make_microbatched_loss_fn as jmicro_fn,
)
from pinn_elastodynamics_torch.cases import wave_confined as tconf
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as tvjp
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.step import (
    make_loss_fn,
    make_microbatched_loss_fn,
    value_and_grad,
)
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.002
MICRO = 4


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


# name -> (build kwargs, parameter maker): soft, and hard + Fourier64.
CONFIGS = {
    "confined_soft": ({}, lambda r: _mlp(r, [3] + [140] * 6 + [7])),
    "confined_hard_fourier64": (
        dict(bc="hard", fourier=64),
        lambda r: {"uv": {"B": r.standard_normal((3, 64)),
                          "mlp": _mlp(r, [128] + [140] * 6 + [7])}}),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def cfg(request):
    kw, make = CONFIGS[request.param]
    host = make(np.random.default_rng(sum(map(ord, request.param))))
    jcase = jconf.build(scale=SCALE, pad_to_multiple_of=8, dtype=np.float64,
                        **kw)
    tcase = tconf.build(scale=SCALE, pad_to_multiple_of=8, dtype=F64,
                        device="cpu", **kw)
    assert tcase.banks["collocation"].n_total % MICRO == 0
    return dict(jcase=jcase, tcase=tcase,
                jparams=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     host),
                tparams=tckpt.params_from_jax(host, device="cpu", dtype=F64))


def _vg(fn, case, params):
    return value_and_grad(lambda p: fn(p, case.banks), params, has_aux=True)


def _with_jet_impl(model, impl):
    if hasattr(model, "uv_model"):
        return dataclasses.replace(model, uv_model=dataclasses.replace(
            model.uv_model, jet_impl=impl))
    return dataclasses.replace(model, jet_impl=impl)


def test_microbatched_loss_matches_full(cfg):
    """Gradient-accumulation loss == full-batch loss: the loss within 1e-10,
    every component within 1e-9 relative, the gradients within rtol 1e-8."""
    case = cfg["tcase"]
    full = make_loss_fn(case.model, case.loss, case.material)
    micro = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                      num_microbatches=MICRO)
    (lf, cf), gf = _vg(full, case, cfg["tparams"])
    (lm, cm), gm = _vg(micro, case, cfg["tparams"])
    assert float(lf) == pytest.approx(float(lm), rel=1e-10)
    assert sorted(cf) == sorted(cm)
    for k in cf:
        assert float(cf[k]) == pytest.approx(float(cm[k]), rel=1e-9), k
    ff = np.concatenate([t.numpy().ravel() for t in tree_leaves(gf)])
    fm = np.concatenate([t.numpy().ravel() for t in tree_leaves(gm)])
    np.testing.assert_allclose(fm, ff, rtol=1e-8, atol=1e-12)


def test_microbatched_loss_matches_jax(cfg):
    """The port's microbatched loss, components and gradients against JAX's
    ``make_microbatched_loss_fn`` under ``jax.jit``, within 1e-10."""
    jcase, tcase = cfg["jcase"], cfg["tcase"]
    jmicro = jmicro_fn(jcase.model, jcase.loss, jcase.material,
                       num_microbatches=MICRO)
    (jl, jc), jg = jax.jit(jax.value_and_grad(jmicro, has_aux=True))(
        cfg["jparams"], jcase.banks)
    micro = make_microbatched_loss_fn(tcase.model, tcase.loss, tcase.material,
                                      num_microbatches=MICRO)
    (tl, tc), tg = _vg(micro, tcase, cfg["tparams"])

    def close(got, want):
        want = np.asarray(want, np.float64)
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(np.asarray(got, np.float64) - want).max()) <= (
            1e-10 * scale)

    close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        close(tc[k], jc[k])
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        close(t.numpy(), j)


def test_microbatches_recompute_each_chunk_on_the_kernel_route(cfg,
                                                              monkeypatch):
    """On the kernel route (the autograd Functions, plain versions on the
    CPU) each microbatch runs the fused forward twice — once forward, once
    recomputed by the checkpoint in the backward — and the fused backward
    once, and the result is the eager route's."""
    tcase = cfg["tcase"]
    kernel = dataclasses.replace(
        tcase, model=_with_jet_impl(tcase.model, "kernel"))
    calls = {"forward": 0, "backward": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tvjp, "fused_jet_stack",
                        counted("forward", tvjp.fused_jet_stack))
    monkeypatch.setattr(tvjp, "fused_seed_jet_stack",
                        counted("forward", tvjp.fused_seed_jet_stack))
    monkeypatch.setattr(tvjp, "fused_mlp_jet_bwd",
                        counted("backward", tvjp.fused_mlp_jet_bwd))
    micro = make_microbatched_loss_fn(kernel.model, kernel.loss,
                                      kernel.material, num_microbatches=MICRO)
    (lk, _), gk = _vg(micro, kernel, cfg["tparams"])
    assert calls == {"forward": 2 * MICRO, "backward": MICRO}
    eager = make_microbatched_loss_fn(tcase.model, tcase.loss, tcase.material,
                                      num_microbatches=MICRO)
    (le, _), ge = _vg(eager, tcase, cfg["tparams"])
    assert float(lk) == pytest.approx(float(le), rel=1e-12)
    for a, b in zip(tree_leaves(gk), tree_leaves(ge), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("micro", [3, 5])
def test_microbatches_must_divide_the_bank(micro):
    case = tconf.build(scale=SCALE, pad_to_multiple_of=8, device="cpu")
    n = case.banks["collocation"].n_total
    assert n % micro
    fn = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                   num_microbatches=micro)
    params = tckpt.params_from_jax(
        _mlp(np.random.default_rng(0), [3] + [140] * 6 + [7]), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        fn(params, case.banks)
