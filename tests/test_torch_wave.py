"""PyTorch port: the three elastic-wave cases (banks, model jets, losses and
gradients of the soft and hard-BC configurations, the wave checkpoints in
``runs/``) against the JAX package, f64 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import wave_confined as jconf
from pinn_elastodynamics_tpu.cases import wave_infinite as jinf
from pinn_elastodynamics_tpu.cases import wave_semi_infinite as jsemi
from pinn_elastodynamics_torch.cases import wave_common
from pinn_elastodynamics_torch.cases import wave_confined as tconf
from pinn_elastodynamics_torch.cases import wave_infinite as tinf
from pinn_elastodynamics_torch.cases import wave_semi_infinite as tsemi
from pinn_elastodynamics_torch.ops.jet import jet_of_fn
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.002
REL = 1e-10

CASES = {
    "wave_confined": (jconf, tconf),
    "wave_infinite": (jinf, tinf),
    "wave_semi_infinite": (jsemi, tsemi),
}
# Collocation, source, IC and edge banks at scale 1.0 (JAX build_banks).
FULL_SIZES = {
    "wave_confined": {"collocation": 146149, "src": 56200, "ic": 5919,
                      "fixed": 28000},
    "wave_infinite": {"collocation": 124830, "src": 70400, "ic": 10201,
                      "up": 30150},
    "wave_semi_infinite": {"collocation": 150470, "src": 32250, "ic": 12000,
                           "up": 15000},
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


def _fourier(rng, hidden):
    return {"B": rng.standard_normal((3, 64)),
            "mlp": _mlp(rng, [128] + list(hidden) + [7])}


# name -> (case, build kwargs, parameter maker): every configuration the
# wave builders offer, at the reference's widths.
CONFIGS = {
    "confined_soft": ("wave_confined", {},
                      lambda r: _mlp(r, [3] + [140] * 6 + [7])),
    "confined_hard": ("wave_confined", dict(bc="hard"),
                      lambda r: {"uv": _mlp(r, [3] + [140] * 6 + [7])}),
    "confined_hard_fourier64": (
        "wave_confined", dict(bc="hard", fourier=64),
        lambda r: {"uv": _fourier(r, [140] * 6)}),
    "infinite": ("wave_infinite", {},
                 lambda r: _mlp(r, [3] + [80] * 8 + [7])),
    "semi_soft": ("wave_semi_infinite", {},
                  lambda r: _mlp(r, [3] + [100] * 8 + [7])),
    "semi_hard": ("wave_semi_infinite", dict(bc="hard"),
                  lambda r: {"uv": _mlp(r, [3] + [100] * 8 + [7])}),
    "semi_hard_fourier64": (
        "wave_semi_infinite", dict(bc="hard", fourier=64),
        lambda r: {"uv": _fourier(r, [100] * 8)}),
}

# The wave checkpoints of the repo: (case, build kwargs, horizon).
CHECKPOINTS = {
    "runs/wave_confined/stage_1_T14.ckpt": ("wave_confined", {}, 14.0),
    "runs/wave_confined_fourier/hybrid_best.ckpt": (
        "wave_confined", dict(bc="hard", fourier=64), 14.0),
    "runs/wave_infinite/stage_1_T20.ckpt": ("wave_infinite", {}, 20.0),
    "runs/wave_semi/stage_1_T16.ckpt": ("wave_semi_infinite", {}, 16.0),
    "runs/wave_semi_fourier/hybrid_best.ckpt": (
        "wave_semi_infinite", dict(bc="hard", fourier=64), 16.0),
}


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _with_jet_impl(model, impl):
    """The same model with its network's jet on ``impl``."""
    if hasattr(model, "uv_model"):
        return dataclasses.replace(model, uv_model=dataclasses.replace(
            model.uv_model, jet_impl=impl))
    return dataclasses.replace(model, jet_impl=impl)


def _cases(case, kw, scale=SCALE, **more):
    jmod, tmod = CASES[case]
    jcase = jmod.build(scale=scale, dtype=np.float64, **kw, **more)
    tcase = tmod.build(scale=scale, dtype=F64, device="cpu", **kw, **more)
    return jcase, tcase


@pytest.mark.parametrize("scale", [0.01, 1.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_banks_bitwise_equal_to_jax(case, scale):
    jmod, tmod = CASES[case]
    want = jmod.build_banks(seed=1111, scale=scale)
    got = tmod.build_banks(seed=1111, scale=scale, device="cpu")
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
        assert {k: b.n_total for k, b in got.items()} == FULL_SIZES[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_banks_keep_the_loss(case):
    rng = np.random.default_rng(7)
    name = {"wave_confined": "confined_soft", "wave_infinite": "infinite",
            "wave_semi_infinite": "semi_soft"}[case]
    params = tckpt.params_from_jax(CONFIGS[name][2](rng), device="cpu",
                                   dtype=F64)
    _, tmod = CASES[case]
    plain = tmod.build(scale=SCALE, dtype=F64, device="cpu")
    padded = tmod.build(scale=SCALE, dtype=F64, device="cpu",
                        pad_to_multiple_of=64)
    assert all(b.n_total % 64 == 0 for b in padded.banks.values())
    a = plain.loss_fn(plain.loss)(params)
    b = padded.loss_fn(padded.loss)(params)
    _close(b, a, 1e-13)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def cfg(request):
    case, kw, make = CONFIGS[request.param]
    host = make(np.random.default_rng(sum(map(ord, request.param))))
    jcase, tcase = _cases(case, kw)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    return dict(name=request.param, jcase=jcase, tcase=tcase, jparams=jparams,
                jmain=jax.jit(jax.value_and_grad(jcase.loss_and_aux_fn(),
                                                 has_aux=True))(jparams),
                tparams=tckpt.params_from_jax(host, device="cpu", dtype=F64))


@pytest.mark.parametrize("jet_impl", ["eager", "kernel"])
def test_main_loss_value_components_and_grad_match_jax(cfg, jet_impl):
    """Value, components and gradient of the main loss over every
    parameter (``Phase(trainable=None)``, so a Fourier ``B`` is trained);
    "kernel" runs the fused autograd Functions with their plain versions on
    the CPU."""
    tcase = dataclasses.replace(
        cfg["tcase"], model=_with_jet_impl(cfg["tcase"].model, jet_impl))
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
    assert cfg["tcase"].phases[0].trainable is None


def test_model_jet_matches_jax(cfg):
    jcase, tcase = cfg["jcase"], cfg["tcase"]
    x = tcase.banks["collocation"].xyt
    want = jcase.model.jet(cfg["jparams"], jnp.asarray(x.numpy()))
    got = tcase.model.jet(cfg["tparams"], x)
    assert want.dtt is None and got.dtt is None
    _close(got.f, want.f)
    _close(got.d, want.d)


def test_case_surface_matches_jax(cfg):
    jcase, tcase = cfg["jcase"], cfg["tcase"]
    assert (tcase.name, tcase.plane, tcase.lb, tcase.ub, tcase.n_frames,
            tcase.fem_offset) == (jcase.name, jcase.plane, jcase.lb, jcase.ub,
                                  jcase.n_frames, jcase.fem_offset)
    assert (tcase.material.E, tcase.material.mu, tcase.material.rho) == (
        jcase.material.E, jcase.material.mu, jcase.material.rho)
    for jp, tp in zip(jcase.phases, tcase.phases, strict=True):
        assert (tp.name, tp.trainable, tp.scale, tp.maxiter, tp.ftol) == (
            jp.name, jp.trainable, jp.scale, jp.maxiter, jp.ftol)
        assert tp.loss.weights == jp.loss.weights
    np.testing.assert_array_equal(tcase.eval_grid, jcase.eval_grid)
    params = tcase.init_params(0)
    want = jcase.init_params(0)
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(a.shape) for a in jax.tree.leaves(want)]


@pytest.mark.parametrize("case, max_t", [("wave_confined", 7.0),
                                         ("wave_infinite", 10.0)])
def test_normalisation_follows_the_horizon_as_in_jax(case, max_t):
    """wave_infinite normalises time to the stage's horizon; the confined
    Fourier embedding stays pinned to 14 s whatever the horizon."""
    kw = dict(bc="hard", fourier=64) if case == "wave_confined" else {}
    jcase, tcase = _cases(case, kw, max_t=max_t)
    jnet = getattr(jcase.model, "uv_model", jcase.model)
    tnet = getattr(tcase.model, "uv_model", tcase.model)
    assert (tnet.lb, tnet.ub) == (jnet.lb, jnet.ub)
    assert tnet.ub[-1] == (14.0 if case == "wave_confined" else max_t)
    assert tcase.ub[-1] == max_t


def test_semi_infinite_fourier_model_keeps_the_eager_jet():
    """The JAX builder leaves the Fourier model's ``jet_impl`` at its
    default (XLA); the port's likewise stays eager, whatever is asked."""
    model = tsemi.build_model(fourier=64, bc="hard", jet_impl="kernel")
    assert model.uv_model.jet_impl == "eager"
    assert tsemi.build_model(jet_impl="kernel").jet_impl == "kernel"
    assert tconf.build_model(fourier=64, jet_impl="kernel").jet_impl == "kernel"


@pytest.mark.parametrize("mod", [tconf, tsemi])
def test_zero_particular_field_follows_its_input(mod):
    """``analytic_part`` under vmap and the jets: zeros of the points'
    dtype, batched like them."""
    x = torch.randn(5, 3, dtype=F64)
    jet = jet_of_fn(mod.analytic_part, x, order=1)
    assert jet.f.shape == (5, 7) and jet.d.shape == (3, 5, 7)
    assert jet.f.dtype == F64
    assert not jet.f.any() and not jet.d.any()


def test_source_bank_points_match_jax():
    from pinn_elastodynamics_tpu.cases import wave_common as jcommon
    from pinn_elastodynamics_tpu.geometry.sources import ricker_wavelet
    from pinn_elastodynamics_torch.geometry import sources

    tt = np.linspace(0, 8, 17)[1:]
    want = jcommon.source_bank_points(xc=1.0, yc=-2.0, r=2.0, n_circle=9,
                                      tt=tt, amplitude_fn=ricker_wavelet)
    got = wave_common.source_bank_points(
        xc=1.0, yc=-2.0, r=2.0, n_circle=9, tt=tt,
        amplitude_fn=sources.ricker_wavelet)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", sorted(CHECKPOINTS))
def test_wave_checkpoint_loss_matches_jax(path):
    """Each wave checkpoint, loaded with numpy, gives the JAX loss on the
    same scale-0.01 banks."""
    case, kw, max_t = CHECKPOINTS[path]
    host = tckpt.load_checkpoint(path, np.float64)["params"]
    jcase, tcase = _cases(case, kw, scale=0.01, max_t=max_t)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    want = jax.jit(jcase.loss_fn(jcase.loss))(jparams)
    with torch.no_grad():
        got = tcase.loss_fn(tcase.loss)(
            tckpt.params_from_jax(host, device="cpu", dtype=F64))
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=REL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_defaults_to_the_gpu(monkeypatch, case):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        CASES[case][1].build(scale=SCALE)
