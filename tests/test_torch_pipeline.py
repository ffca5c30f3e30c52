"""PyTorch port: L-BFGS on the quarter plate's phases, ``run_pipeline`` with
checkpoint and resume, the Adam warm-up and reference pickles, against the
JAX package (f64 on the CPU, scale 0.02, narrow nets)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import base as jbase
from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.models import analytic_bc as janalytic
from pinn_elastodynamics_tpu.models import fields as jfields
from pinn_elastodynamics_tpu.models import fourier as jfourier
from pinn_elastodynamics_tpu.train import adam as jadam
from pinn_elastodynamics_tpu.train import checkpoint as jckpt
from pinn_elastodynamics_tpu.train.lbfgs import minimize as jminimize
from pinn_elastodynamics_torch.cases import base as tbase
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.models import analytic_bc as tanalytic
from pinn_elastodynamics_torch.models import fields as tfields
from pinn_elastodynamics_torch.models import fourier as tfourier
from pinn_elastodynamics_torch.train import adam as tadam
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.lbfgs import minimize as tminimize
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.02
REL = 1e-8


def _mlp(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


def _net_bc_cases():
    """The net-BC plate with uv 3→16→16→5 and dist, part 3→8→5."""
    jspec = jfields.FieldSpec(ndim=2, formulation=jfields.SECOND_ORDER)
    tspec = tfields.FieldSpec(ndim=2, formulation=tfields.SECOND_ORDER)
    widths = dict(uv_hidden=(16, 16), dist_hidden=(8,), part_hidden=(8,))
    jcase = jplate.build(scale=SCALE, dtype=np.float64)
    tcase = tplate.build(scale=SCALE, dtype=F64, device="cpu")
    jcase.model = jfields.CompositeFieldModel(spec=jspec, **widths)
    tcase.model = tfields.CompositeFieldModel(spec=tspec, jet_impl="kernel",
                                              **widths)
    rng = np.random.default_rng(3)
    host = {"uv": _mlp(rng, [3, 16, 16, 5]), "dist": _mlp(rng, [3, 8, 5]),
            "part": _mlp(rng, [3, 8, 5])}
    return jcase, tcase, host


def _analytic_fourier_cases():
    """The analytic-BC plate with an 8-feature Fourier uv net, 16→16→16→5."""
    jspec = jfields.FieldSpec(ndim=2, formulation=jfields.SECOND_ORDER)
    tspec = tfields.FieldSpec(ndim=2, formulation=tfields.SECOND_ORDER)
    net = dict(hidden=(16, 16), n_features=8, feature_scale=2.0,
               normalize=True)
    jcase = jplate.build(scale=SCALE, dtype=np.float64, bc="analytic")
    tcase = tplate.build(scale=SCALE, dtype=F64, device="cpu", bc="analytic")
    jcase.model = janalytic.AnalyticCompositeFieldModel(
        spec=jspec, uv_model=jfourier.FourierMLPFieldModel(
            spec=jspec, lb=jplate.LB, ub=jplate.UB, **net),
        dist_fn=jplate.analytic_dist, part_fn=jplate.analytic_part)
    tcase.model = tanalytic.AnalyticCompositeFieldModel(
        spec=tspec, uv_model=tfourier.FourierMLPFieldModel(
            spec=tspec, lb=tplate.LB, ub=tplate.UB, jet_impl="kernel", **net),
        dist_fn=tplate.analytic_dist, part_fn=tplate.analytic_part)
    rng = np.random.default_rng(4)
    host = {"uv": {"B": 2.0 * rng.standard_normal((3, 8)),
                   "mlp": _mlp(rng, [16, 16, 16, 5])}}
    return jcase, tcase, host


@pytest.fixture(scope="module")
def net_bc():
    return _net_bc_cases()


def _jtree(host):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)


def _ttree(host):
    return tckpt.params_from_jax(host, device="cpu", dtype=F64)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


@pytest.mark.parametrize("config,trainable", [
    ("net_bc", "uv"), ("analytic_fourier", "uv.mlp")])
def test_lbfgs_phase_matches_jax(net_bc, config, trainable):
    """10 L-BFGS iterations of the main phase through the autograd
    Functions (plain versions on the CPU): the JAX history within 1e-8."""
    jcase, tcase, host = (net_bc if config == "net_bc"
                          else _analytic_fourier_cases())
    jphase = dataclasses.replace(jcase.phases[-1], trainable=trainable)
    tphase = dataclasses.replace(tcase.phases[-1], trainable=trainable)
    jfn, jsub, _ = jbase._phase_loss_fn(jcase, jphase, _jtree(host))
    tfn, tsub, _ = tbase._phase_loss_fn(tcase, tphase, _ttree(host))
    jres = jminimize(jfn, jsub, maxiter=10, ftol=jphase.ftol)
    tres = tminimize(tfn, tsub, maxiter=10, ftol=tphase.ftol)
    assert tres.n_iters == jres.n_iters == 10
    assert _rel(tres.loss_history, jres.loss_history) <= REL
    assert tres.loss_history[-1] < tres.loss_history[0]
    for a, b in zip(tree_leaves(tres.params), jax.tree.leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7 * max(1.0, np.abs(b).max()))


def _eager(case):
    model = dataclasses.replace(case.model, jet_impl="eager")
    return dataclasses.replace(case, model=model)


BUDGET = {"dist": 4, "part": 4, "uv": 6}


def test_run_pipeline_matches_jax(net_bc):
    """dist → part → uv with short budgets and a 3-step Adam warm-up
    before uv: every phase's history and final loss within 1e-8."""
    jcase, tcase, host = net_bc
    jcase = dataclasses.replace(jcase, adam_iters=3, adam_lr=1e-3)
    tcase = dataclasses.replace(_eager(tcase), adam_iters=3, adam_lr=1e-3)
    assert [p.name for p in tcase.phases] == ["dist", "part", "uv"]
    jparams, jres = jbase.run_pipeline(jcase, _jtree(host), dtype=jnp.float64,
                                       maxiter_override=BUDGET, segment=2)
    ended = []
    tparams, tres = tbase.run_pipeline(
        tcase, _ttree(host), dtype=F64, maxiter_override=BUDGET, segment=2,
        on_phase_end=lambda phase, p, res: ended.append(phase.name))
    assert ended == list(BUDGET)
    for name, budget in BUDGET.items():
        assert tres[name].n_iters == jres[name].n_iters == budget
        assert _rel(tres[name].loss_history, jres[name].loss_history) <= REL
        assert _rel(tres[name].final_loss, jres[name].final_loss) <= REL
        assert tres[name].loss_history[-1] < tres[name].loss_history[0]
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7 * max(1.0, np.abs(b).max()))


TARGET_SCALE = 0.01
PRETRAIN = 3
TARGET_MAXITER = 10


def test_uv_phase_stops_at_target_like_jax():
    """The net-BC plate at its published widths (uv 8 x 70, dist and part
    4 x 20), scale 0.01 padded to 8, from JAX's seed-0 parameters in
    float64: 3 pretraining iterations of dist and of part, then the uv
    phase to a threshold between the 6th and 7th losses of JAX's uncut run;
    the same iterations (7) and the final loss within 1e-8 relative."""
    jcase = jplate.build(scale=TARGET_SCALE, pad_to_multiple_of=8,
                         dtype=np.float64, jet_impl="xla")
    host = jax.tree.map(np.asarray, jcase.init_params(seed=0))
    pretrain = {"dist": PRETRAIN, "part": PRETRAIN, "uv": 0}
    jp, _ = jbase.run_pipeline(jcase, _jtree(host), dtype=jnp.float64,
                               maxiter_override=pretrain, segment=50)
    jfn, jsub, _ = jbase._phase_loss_fn(jcase, jcase.phases[-1], jp)
    hist = np.asarray(jminimize(jfn, jsub, maxiter=TARGET_MAXITER,
                                segment=TARGET_MAXITER).loss_history)
    assert hist[6] < hist[5], hist
    threshold = float(0.5 * (hist[5] + hist[6]))
    jres = jminimize(jfn, jsub, maxiter=TARGET_MAXITER,
                     segment=TARGET_MAXITER, target=threshold)
    assert jres.n_iters == 7

    tcase = tplate.build(scale=TARGET_SCALE, pad_to_multiple_of=8, dtype=F64,
                         device="cpu")
    tp, _ = tbase.run_pipeline(tcase, _ttree(host), dtype=F64,
                               maxiter_override=pretrain, segment=50)
    tfn, tsub, _ = tbase._phase_loss_fn(tcase, tcase.phases[-1], tp)
    tres = tminimize(tfn, tsub, maxiter=TARGET_MAXITER, segment=10,
                     target=threshold)
    assert tres.n_iters == jres.n_iters
    assert tres.final_loss <= threshold
    assert _rel(tres.final_loss, jres.final_loss) <= REL


def test_pipeline_mid_phase_resume(net_bc, tmp_path):
    """A run checkpointed every segment and cut after 4 uv iterations,
    resumed with ``resume=True`` and a budget of 8: the remaining 4
    iterations only, ending bitwise where an uncut run of 8 ends."""
    _, tcase, host = net_bc
    tcase = _eager(tcase)
    budget = dict(BUDGET, uv=8)
    _, uncut = tbase.run_pipeline(tcase, _ttree(host), dtype=F64,
                                  maxiter_override=budget, segment=2)
    live = str(tmp_path / "live.ckpt")
    _, cut = tbase.run_pipeline(
        tcase, _ttree(host), dtype=F64, maxiter_override=dict(BUDGET, uv=4),
        segment=2, checkpoint_path=live, checkpoint_every_segments=1)
    saved = tckpt.load_checkpoint(live)
    assert saved["phase"] == "uv" and saved["iters"] == 4
    assert saved["lbfgs_carry"][1]["count"] == 4
    phases = []
    params, resumed = tbase.run_pipeline(
        tcase, None, dtype=F64, maxiter_override=budget, segment=2,
        checkpoint_path=live, checkpoint_every_segments=1, resume=True,
        on_phase_end=lambda phase, p, res: phases.append(phase.name))
    assert phases == ["uv"] and resumed["uv"].n_iters == 4
    np.testing.assert_array_equal(
        np.concatenate([cut["uv"].loss_history, resumed["uv"].loss_history]),
        uncut["uv"].loss_history)
    assert float(resumed["uv"].final_loss) == float(uncut["uv"].final_loss)
    assert tckpt.load_checkpoint(live)["iters"] == 8
    # A checkpoint at the phase's whole budget: nothing left to run.
    again, rest = tbase.run_pipeline(
        tcase, None, dtype=F64, maxiter_override=budget, segment=2,
        checkpoint_path=live, resume=True)
    assert rest == {}
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        assert torch.equal(a, b)


def test_run_adam_segments_log_and_hook_match_jax(net_bc, capsys):
    """Adam in segments of 2 with ``log_every`` and ``on_segment``: the
    JAX loop's hook calls, log lines and history."""
    jcase, tcase, host = net_bc
    jseen, tseen = [], []
    jres = jadam.run_adam(
        jcase.loss_and_aux_fn(), _jtree(host), 1e-3, iters=5, segment=2,
        log_every=2, on_segment=lambda d, p, s, h: jseen.append(
            (d, len(h["loss"]))))
    jlog = capsys.readouterr().out
    tres = tadam.run_adam(
        _eager(tcase).loss_and_aux_fn(), _ttree(host), 1e-3, iters=5,
        segment=2, log_every=2, on_segment=lambda d, p, s, h: tseen.append(
            (d, len(h["loss"]), s["count"])))
    tlog = capsys.readouterr().out
    assert [s[:2] for s in tseen] == jseen == [(2, 2), (4, 2), (5, 1)]
    assert [s[2] for s in tseen] == [2, 4, 5]
    assert tlog.count("adam it") == jlog.count("adam it") == 2
    assert [line.split(":")[0] for line in tlog.splitlines()] == [
        line.split(":")[0] for line in jlog.splitlines()]
    assert sorted(tres.history) == sorted(jres.history)
    for k in jres.history:
        assert _rel(tres.history[k], jres.history[k]) <= 1e-10


def test_case_fields_match_jax(net_bc):
    jcase, tcase, _ = net_bc
    assert tcase.n_frames == jcase.n_frames == 81
    assert jcase.fem_dir.endswith(tcase.fem_dir)
    np.testing.assert_array_equal(tcase.eval_grid, jcase.eval_grid)
    assert tcase.max_t == jcase.max_t == 10.0
    assert tcase.frame_time(20) == jcase.frame_time(20) == 2.5
    assert (tcase.adam_iters, tcase.adam_lr) == (jcase.adam_iters,
                                                 jcase.adam_lr)


def test_save_reference_pickle_reads_back_in_jax(tmp_path):
    params = _ttree({"uv": _mlp(np.random.default_rng(6), [3, 7, 5])})["uv"]
    path = str(tmp_path / "uvNN.pickle")
    tckpt.save_reference_pickle(path, params)
    want = [layer[k].numpy() for layer in params for k in ("W", "b")]
    got = jckpt.load_reference_pickle(path, jnp.float64)
    back = tckpt.load_reference_pickle(path, device="cpu", dtype=F64)
    for tree in (got, back):
        leaves = [np.asarray(layer[k]) for layer in tree for k in ("W", "b")]
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(a, b)
