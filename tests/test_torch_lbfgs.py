"""PyTorch port: L-BFGS with the zoom line search (train/lbfgs.py) against
the JAX package's ``minimize`` (optax.lbfgs), f64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinn_elastodynamics_tpu.train import checkpoint as jckpt
from pinn_elastodynamics_tpu.train.lbfgs import minimize as jminimize
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.lbfgs import minimize as tminimize
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
REL = 1e-10
A = np.linspace(1.0, 50.0, 30)


def jrosen(p):
    x = p["x"]
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def trosen(p):
    x = p["x"]
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def jquad(p):
    return 0.5 * jnp.sum(jnp.asarray(A) * p["x"] ** 2)


def tquad(p):
    return 0.5 * torch.sum(torch.as_tensor(A) * p["x"] ** 2)


def jnested(p):
    x = jnp.concatenate([p["a"], p["b"]["c"].ravel()])
    return jrosen({"x": x}) + jnp.sum((p["b"]["d"][0] - x[:2]) ** 2)


def tnested(p):
    x = torch.cat([p["a"], p["b"]["c"].reshape(-1)])
    return trosen({"x": x}) + torch.sum((p["b"]["d"][0] - x[:2]) ** 2)


def jnan(p):
    return jnp.sum(p["x"] ** 2) + jnp.sqrt(-1.0 - p["x"][0] ** 2)


def tnan(p):
    return torch.sum(p["x"] ** 2) + torch.sqrt(-1.0 - p["x"][0] ** 2)


# name -> (JAX loss, port loss, numpy start)
PROBLEMS = {
    "quadratic": (jquad, tquad, {"x": np.ones(30)}),
    "rosenbrock": (jrosen, trosen, {"x": np.zeros(12)}),
    "nested": (jnested, tnested, {
        "a": np.full(3, -0.5),
        "b": {"c": np.linspace(0.2, 0.8, 4).reshape(2, 2),
              "d": [np.array([0.3, -0.2])]}}),
}


def _jtree(host):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)


def _ttree(host):
    return tckpt.params_from_jax(host, device="cpu", dtype=F64)


def _counting(fn):
    def wrapped(p):
        wrapped.calls += 1
        return fn(p)

    wrapped.calls = 0
    return wrapped


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-300)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_history_and_linesearch_steps_match_jax(name):
    """20 iterations, one per segment so that each iteration's line-search
    count is read from the carry: the same counts, the same history within
    1e-10 relative, and one value+grad per line-search step plus the seed."""
    jfn, tfn, host = PROBLEMS[name]
    jsteps, tsteps = [], []
    jres = jminimize(
        jfn, _jtree(host), maxiter=20, segment=1,
        on_segment=lambda k, p, h, carry: jsteps.append(
            int(optax.tree.get(carry[1], "num_linesearch_steps"))))
    tfn = _counting(tfn)
    tres = tminimize(
        tfn, _ttree(host), maxiter=20, segment=1,
        on_segment=lambda k, p, h, carry: tsteps.append(
            carry[1]["num_linesearch_steps"]))
    assert tres.n_iters == jres.n_iters == 20
    assert tsteps == jsteps
    assert tfn.calls == 1 + sum(tsteps)
    assert tres.loss_history.shape == (20,)
    assert _rel(tres.loss_history, jres.loss_history).max() <= REL
    assert float(tres.final_loss) == tres.loss_history[-1]
    for a, b in zip(tree_leaves(tres.params), jax.tree.leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("stop", ["ftol", "gtol", "target", "nonfinite"])
def test_stops_match_jax(stop):
    """Each stop ends the run at the same iteration as in JAX; a loss that
    is NaN from the start fails its line search and stops after one."""
    kw, jfn, tfn, host = {
        "ftol": (dict(ftol=1e-2, patience=3), jrosen, trosen,
                 {"x": np.zeros(8)}),
        "gtol": (dict(gtol=1e-3), jquad, tquad, {"x": np.ones(30)}),
        "target": (dict(target=1e-3), jrosen, trosen, {"x": np.zeros(8)}),
        "nonfinite": ({}, jnan, tnan, {"x": np.ones(3)}),
    }[stop]
    jres = jminimize(jfn, _jtree(host), maxiter=200, **kw)
    tres = tminimize(tfn, _ttree(host), maxiter=200, **kw)
    assert 0 < tres.n_iters == jres.n_iters < 200
    hist = tres.loss_history
    if stop == "nonfinite":
        assert tres.n_iters == 1 and np.isnan(hist[0])
        assert np.isnan(np.asarray(jres.loss_history)[0])
        return
    # Rounding differences grow as the loss falls: compare the first 20.
    assert _rel(hist[:20], jres.loss_history[:20]).max() <= REL
    if stop == "ftol":
        assert tres.carry[3] == 3       # patience used up
    if stop == "gtol":
        assert float(tres.carry[1]["grad"].abs().max()) <= 1e-3
    if stop == "target":
        assert hist[-1] <= 1e-3 < hist[-2]


@pytest.mark.parametrize("with_carry", [False, True])
def test_segments_and_hook_match_jax(with_carry):
    """Segments of 25, a hook between them; a budget that is not a whole
    number of segments runs the last segment whole, as the JAX loop does."""
    jseen, tseen = [], []
    if with_carry:
        def hook(seen):
            return lambda k, p, h, carry=None: seen.append((k, len(h), carry))
    else:
        def hook(seen):
            return lambda k, p, h: seen.append((k, len(h), p))
    host = {"x": np.zeros(10)}
    jres = jminimize(jrosen, _jtree(host), maxiter=60, segment=25,
                     on_segment=hook(jseen))
    tres = tminimize(trosen, _ttree(host), maxiter=60, segment=25,
                     on_segment=hook(tseen))
    assert [s[:2] for s in tseen] == [s[:2] for s in jseen]
    assert [s[0] for s in tseen] == [25, 50, 64]
    assert sum(s[1] for s in tseen) == tres.n_iters == jres.n_iters
    assert _rel(tres.loss_history[:20], jres.loss_history[:20]).max() <= REL
    k, _, last = tseen[-1]
    if with_carry:
        params, opt_state, f_prev, flat, done = last
        assert opt_state["count"] == k
        assert torch.equal(params["x"], tres.params["x"])
        assert float(f_prev) == tres.loss_history[-1] and bool(done)
    else:
        assert torch.equal(last["x"], tres.params["x"])


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    """50 iterations, the carry through ``save_checkpoint`` and back, 50
    more: the uncut run's parameters and history, bitwise."""
    p0 = {"x": torch.zeros(30, dtype=F64)}
    full = tminimize(trosen, p0, maxiter=100, segment=25)
    assert full.n_iters == 100
    part1 = tminimize(trosen, p0, maxiter=50, segment=25)
    path = str(tmp_path / "mid.ckpt")
    tckpt.save_checkpoint(path, {"lbfgs_carry": part1.carry})
    host = tckpt.load_checkpoint(path)
    assert jckpt.load_checkpoint(path)["lbfgs_carry"][1]["count"] == 50
    restored = tckpt.tensors_from_checkpoint(host, device="cpu", dtype=F64)
    carry = tuple(restored["lbfgs_carry"])
    assert carry[3].dtype == torch.int32 and carry[4].dtype == torch.bool
    assert carry[2].shape == carry[1]["learning_rate"].shape == ()
    evals = _counting(trosen)
    part2 = tminimize(evals, p0, maxiter=50, segment=25, init_carry=carry)
    assert part2.n_iters == 50
    assert torch.equal(part2.params["x"], full.params["x"])
    np.testing.assert_array_equal(
        np.concatenate([part1.loss_history, part2.loss_history]),
        full.loss_history)
    # No seed evaluation on resume: only the line searches evaluate.
    assert evals.calls == _steps_after(p0, 50)


def _steps_after(p0, start):
    """Line-search steps of iterations start+1 .. start+50 of the 30-d
    Rosenbrock run, read one iteration per segment."""
    steps = []
    tminimize(trosen, p0, maxiter=start + 50, segment=1,
              on_segment=lambda k, p, h, carry: steps.append(
                  carry[1]["num_linesearch_steps"]))
    return sum(steps[start:])


def test_resume_keeps_curvature_history():
    """A resumed run descends at once (warm inverse-Hessian estimate) and
    does no worse than a cold restart from the same point."""
    p0 = {"x": torch.zeros(20, dtype=F64)}
    part1 = tminimize(trosen, p0, maxiter=60, segment=20)
    resumed = tminimize(trosen, p0, maxiter=20, segment=20,
                        init_carry=part1.carry)
    cold = tminimize(trosen, part1.params, maxiter=20, segment=20)
    assert resumed.carry[1]["count"] == 80
    assert float(resumed.final_loss) <= float(part1.final_loss)
    assert float(resumed.final_loss) <= float(cold.final_loss) * 1.001
    assert not np.array_equal(resumed.loss_history, cold.loss_history)
