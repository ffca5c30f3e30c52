"""PyTorch port: the time-horizon curriculum — horizon extension, skipping
completed stages, a bitwise mid-stage resume from the live checkpoint, and
stage losses against the JAX ``run_time_curriculum`` (f64 on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import wave_infinite as jinf
from pinn_elastodynamics_tpu.train import curriculum as jcurriculum
from pinn_elastodynamics_torch.cases import wave_confined as tconf
from pinn_elastodynamics_torch.cases import wave_infinite as tinf
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train import curriculum
from pinn_elastodynamics_torch.train.curriculum import (
    Stage,
    run_time_curriculum,
)
from pinn_elastodynamics_torch.utils.logging import MetricLogger
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.002
SHORT = dict(warmup_iters=2, warmup_segment=2, segment=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _builder(**kw):
    kw.setdefault("scale", SCALE)
    return tconf.build(**kw)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_curriculum_stages_extend_horizon(tmp_path):
    stages = [Stage(max_t=7.0, maxiter=10), Stage(max_t=14.0, maxiter=10)]
    log = tmp_path / "metrics.jsonl"
    with MetricLogger(str(log)) as logger:
        params, summaries = run_time_curriculum(
            _builder, stages, seed=3, checkpoint_dir=str(tmp_path),
            device="cpu", logger=logger,
        )
    assert [s["max_t"] for s in summaries] == [7.0, 14.0]
    assert all(np.isfinite(s["final_loss"]) for s in summaries)
    assert log.read_text().count('"event": "curriculum_stage"') == 2
    # Stage checkpoints written, live checkpoints superseded.
    assert os.path.exists(tmp_path / "stage_0_T7.ckpt")
    assert os.path.exists(tmp_path / "stage_1_T14.ckpt")
    assert not any(p.name.endswith("_live.ckpt") for p in tmp_path.iterdir())
    # Warm start helps: the T=14 loss starting from the T=7 params is below
    # a cold T=14 init's loss.
    case14 = _builder(max_t=14.0, device="cpu")
    with torch.no_grad():
        cold = float(case14.loss_fn(case14.loss)(case14.init_params(seed=3)))
    assert summaries[1]["final_loss"] < cold
    assert all(t.device.type == "cpu" for t in tree_leaves(params))


def test_curriculum_resume_skips_completed(tmp_path):
    stages = [Stage(max_t=7.0, maxiter=5), Stage(max_t=14.0, maxiter=5)]
    p1, s1 = run_time_curriculum(
        _builder, stages, seed=3, checkpoint_dir=str(tmp_path), device="cpu",
    )
    # A second run resumes from the checkpoints without re-optimizing.
    p2, s2 = run_time_curriculum(
        _builder, stages, seed=3, checkpoint_dir=str(tmp_path), device="cpu",
    )
    assert all(s.get("resumed") for s in s2)
    assert [s["final_loss"] for s in s2] == [s["final_loss"] for s in s1]
    assert _equal(p1, p2)


class _Cut(Exception):
    """Stands for a run killed after a live checkpoint was written."""


def _cut_after(n_segments):
    """``minimize`` that stops the run after ``n_segments`` segment hooks
    (over all stages), each hook having written its live checkpoint."""
    real, seen = curriculum.minimize, [0]

    def minimize(*args, on_segment=None, **kw):
        def hook(it, p, hist, *, carry=None):
            on_segment(it, p, hist, carry=carry)
            seen[0] += 1
            if seen[0] == n_segments:
                raise _Cut

        return real(*args, on_segment=hook, **kw)

    return minimize


@pytest.mark.parametrize("cut", [1, 5, 6])
def test_live_checkpoint_resume_is_bitwise_equal_to_uncut(tmp_path,
                                                          monkeypatch, cut):
    """Each stage runs a warm-up block and a production block in segments
    of 2 (3 segments per stage).  Cut in stage 0's warm-up (1), in the
    middle of stage 1 (5) and at stage 1's budget before its checkpoint
    (6, scored as it is); the resumed run ends on the uncut run's
    parameters, bitwise."""
    stages = [Stage(max_t=7.0, maxiter=6, **SHORT),
              Stage(max_t=14.0, maxiter=6, **SHORT)]
    kw = dict(seed=3, device="cpu", dtype=F64,
              builder_kwargs=dict(scale=SCALE))
    uncut, s_uncut = run_time_curriculum(
        tconf.build, stages, checkpoint_dir=str(tmp_path / "uncut"), **kw)

    cut_dir = tmp_path / "cut"
    with monkeypatch.context() as m:
        m.setattr(curriculum, "minimize", _cut_after(cut))
        with pytest.raises(_Cut):
            run_time_curriculum(tconf.build, stages,
                                checkpoint_dir=str(cut_dir), **kw)
    stage = (cut - 1) // 3
    live = tckpt.load_checkpoint(str(cut_dir / f"stage_{stage}_live.ckpt"))
    assert live["iters"] == 2 * ((cut - 1) % 3 + 1)
    resumed, s_resumed = run_time_curriculum(
        tconf.build, stages, checkpoint_dir=str(cut_dir), **kw)
    assert _equal(resumed, uncut)
    assert [s["iters"] for s in s_resumed] == [6, 6]
    assert bool(s_resumed[0].get("resumed")) == (stage == 1)
    np.testing.assert_allclose(s_resumed[1]["final_loss"],
                               s_uncut[1]["final_loss"], rtol=1e-12)
    assert not (cut_dir / f"stage_{stage}_live.ckpt").exists()


def test_stage_losses_match_jax():
    """wave_infinite 10 s → 20 s (its normalisation follows the horizon),
    an Adam warm-up in the first stage, warm-up and production blocks of
    L-BFGS: each stage's final loss and the final parameters against JAX."""
    stages_kw = [dict(max_t=10.0, maxiter=4, adam_iters=2, **SHORT),
                 dict(max_t=20.0, maxiter=4, **SHORT)]
    rng = np.random.default_rng(11)
    dims = [3] + [80] * 8 + [7]
    host = [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]
    jparams, jsum = jcurriculum.run_time_curriculum(
        lambda **kw: jinf.build(scale=SCALE, dtype=np.float64, **kw),
        [jcurriculum.Stage(**s) for s in stages_kw],
        params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host))
    tparams, tsum = run_time_curriculum(
        tinf.build, [Stage(**s) for s in stages_kw],
        params=tckpt.params_from_jax(host, device="cpu", dtype=F64),
        device="cpu", dtype=F64, builder_kwargs=dict(scale=SCALE))
    assert [s["iters"] for s in tsum] == [s["iters"] for s in jsum] == [4, 4]
    for t, j in zip(tsum, jsum):
        np.testing.assert_allclose(t["final_loss"], j["final_loss"],
                                   rtol=1e-8)
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8 * max(1.0, float(np.abs(b).max())))


def test_curriculum_defaults_to_the_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_time_curriculum(_builder, [Stage(max_t=7.0, maxiter=1)])
