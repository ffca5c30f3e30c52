"""PyTorch port: residual-based adaptive sampling
(``geometry/adaptive.py``) and the debugging helpers (``utils/debug.py``)
against the JAX package on the CPU, in float64; the profiling helpers
(``utils/profiling.py``) on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.banks import make_bank as jmake_bank
from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.geometry import adaptive as jad
from pinn_elastodynamics_tpu.models import fields as jfields
from pinn_elastodynamics_tpu.ops.elasticity import Material as JMaterial
from pinn_elastodynamics_tpu.utils import debug as jdebug
from pinn_elastodynamics_torch.banks import make_bank
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.geometry import adaptive as tad
from pinn_elastodynamics_torch.models import fields as tfields
from pinn_elastodynamics_torch.ops.elasticity import (
    Material,
    PLANE_STRAIN,
    PLANE_STRESS,
)
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.utils import debug as tdebug
from pinn_elastodynamics_torch.utils import profiling as tprof

F64 = torch.float64
REL = 1e-10


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


def _wave_mlp(jet_impl="auto"):
    """A 3 -> 16 x 2 -> 7 first-order (wave) field model in both packages,
    plane strain at E=2.5, nu=0.25, rho=1, seeded float64 weights."""
    spec = dict(ndim=2, formulation=tfields.FIRST_ORDER)
    tmodel = tfields.MLPFieldModel(spec=tfields.FieldSpec(**spec),
                                   hidden=(16, 16), jet_impl=jet_impl)
    jmodel = jfields.MLPFieldModel(spec=jfields.FieldSpec(**spec),
                                   hidden=(16, 16))
    host = _mlp(np.random.default_rng(0), [3, 16, 16, 7])
    mats = (Material(2.5, 0.25, 1.0), JMaterial(2.5, 0.25, 1.0))
    return (tmodel, jmodel, host, mats, PLANE_STRAIN,
            lambda rng, n: rng.uniform(size=(n, 3)))


def _plate(jet_impl="auto"):
    """The net-BC plate composite with the repo's checkpoint weights."""
    host = tckpt.load_checkpoint("runs/plate_v2/hybrid_best.ckpt")["params"]
    mats = (Material(20.0, 0.25, 1.0), JMaterial(20.0, 0.25, 1.0))

    def points(rng, n):
        xy = rng.uniform(0.0, 0.5, (3 * n, 2))
        xy = xy[np.hypot(xy[:, 0], xy[:, 1]) > 0.1][:n]
        return np.concatenate([xy, rng.uniform(0.0, 10.0, (n, 1))], 1)

    return (tplate.build_model(jet_impl=jet_impl),
            jplate.build_model(jet_impl="xla"), host, mats, PLANE_STRESS,
            points)


MODELS = {"wave_mlp": _wave_mlp, "plate_net_bc": _plate}


def _setup(name, jet_impl="auto"):
    tmodel, jmodel, host, (tmat, jmat), plane, points = MODELS[name](jet_impl)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    tparams = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    return (tmodel, tparams, tmat), (jmodel, jparams, jmat), plane, points


@pytest.mark.parametrize("jet_impl", ["auto", "kernel"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_pointwise_residual_norm_matches_jax(name, jet_impl):
    """The per-point residual norm in float64 within 1e-10, on the eager
    jet and on the fused Functions' plain versions (the kernel route)."""
    t, j, plane, points = _setup(name, jet_impl)
    xyt = points(np.random.default_rng(1), 300)
    got = tad.pointwise_residual_norm(*t, plane, torch.as_tensor(xyt))
    want = np.asarray(jad.pointwise_residual_norm(*j, plane,
                                                  jnp.asarray(xyt)))
    assert got.dtype == F64 and got.shape == (300,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_topk_refine_matches_jax(name):
    """Distinct residuals: the same slots take the same candidates, with
    the same info; a padded bank gives its padding rows first (they tie at
    -inf and go in index order, as ``lax.top_k`` orders ties)."""
    t, j, plane, points = _setup(name)
    rng = np.random.default_rng(2)
    cands = points(rng, 200)
    for n_real, pad, k in ((40, 1, 7), (20, 8, 6)):
        pts = points(rng, n_real)
        tbank = make_bank(pts, dtype=F64, pad_to_multiple_of=pad,
                          device="cpu")
        jbank = jmake_bank(pts, dtype=jnp.float64, pad_to_multiple_of=pad)
        tnew, tinfo = tad.topk_refine(*t, plane, tbank, cands, k)
        jnew, jinfo = jad.topk_refine(*j, plane, jbank, cands, k)
        assert np.array_equal(tnew.xyt.numpy(), np.asarray(jnew.xyt))
        assert np.array_equal(tnew.mask.numpy(), np.asarray(jnew.mask))
        assert tnew.values == {} and tinfo["replaced"] == k
        for key in ("cand_residual_mean", "evicted_residual_mean"):
            assert tinfo[key] == pytest.approx(jinfo[key], rel=REL)
        n_pad = tbank.n_total - n_real
        assert float(tnew.mask.sum()) == min(tbank.n_total, n_real + k)
        if n_pad:   # every padding row became a real point
            assert bool((tnew.mask[n_real:] == 1).all())
    # The original bank is left as it was.
    assert float(tbank.mask.sum()) == 20


def test_topk_refine_refuses_value_banks():
    t, _, plane, _ = _setup("wave_mlp")
    bank = make_bank(np.zeros((8, 3)), {"v": np.zeros(8)}, dtype=F64,
                     device="cpu")
    with pytest.raises(ValueError, match="value-free"):
        tad.topk_refine(*t, plane, bank, np.zeros((8, 3)), k=2)


@pytest.mark.parametrize("power, floor", [(1.0, 0.1), (2.0, 0.0)])
def test_residual_resample_matches_jax(power, floor):
    """The same points drawn in float64 (the pool rounded to f32 first on
    both sides), over three batches; importance raises the mean
    residual."""
    t, j, plane, points = _setup("wave_mlp")
    pool = points(np.random.default_rng(3), 2000)
    kw = dict(power=power, uniform_floor=floor, seed=1, batch=768)
    got = tad.residual_resample(*t, plane, pool, 500, **kw)
    want = jad.residual_resample(*j, plane, pool, 500, **kw)
    assert got.shape == (500, 3) and np.array_equal(got, want)
    r = lambda x: tad.pointwise_residual_norm(*t, plane, torch.as_tensor(x))
    assert float(r(got).mean()) > float(r(pool).mean())


def test_assert_finite_names_the_leaf_as_jax_does():
    tdebug.assert_finite({"a": torch.ones(3)})
    tdebug.assert_finite({"n": torch.arange(3)})    # integer leaves pass
    bad = np.array([1.0, np.nan, np.inf])
    for tree, name in (({"a": {"b": bad}}, "p"),
                       ({"uv": [{"W": np.ones(2), "b": bad}]}, "params")):
        with pytest.raises(FloatingPointError) as jerr:
            jdebug.assert_finite(jax.tree.map(jnp.asarray, tree), name=name)
        ttree = jax.tree.map(lambda a: torch.as_tensor(a), tree)
        with pytest.raises(FloatingPointError) as terr:
            tdebug.assert_finite(ttree, name=name)
        assert str(terr.value) == str(jerr.value)
    assert str(terr.value) == ("params['uv'][0]['b']: 2 non-finite values "
                               "(shape (3,))")


def test_tree_max_abs_diff_matches_jax():
    a = {"x": np.zeros(3), "y": [np.ones(2), np.full(1, 2.0)]}
    b = {"x": np.full(3, 0.5), "y": [np.ones(2), np.full(1, -1.25)]}
    ta, tb = (jax.tree.map(torch.as_tensor, t) for t in (a, b))
    got = tdebug.tree_max_abs_diff(ta, tb)
    assert got == jdebug.tree_max_abs_diff(a, b) == 3.25
    assert tdebug.tree_max_abs_diff({}, {}) == 0.0


def test_nan_debugging_scope():
    prev = torch.is_anomaly_enabled()
    with tdebug.nan_debugging(False):
        assert torch.is_anomaly_enabled() == prev
    with tdebug.nan_debugging(True):
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    assert torch.is_anomaly_enabled() == prev


def test_timers_and_trace_on_the_cpu(tmp_path):
    """The trace writes a profiler file only when given a directory, with
    the program's spans of the same seconds beside it on the profiler file's
    clock."""
    x = torch.ones(64, 64)
    with tprof.profiler_trace(None):
        with tprof.span("outside") as sp:
            assert sp is tprof.NO_SPAN
    with tprof.profiler_trace(str(tmp_path)):
        with tprof.span("request", points=64):
            with torch.profiler.record_function("inside"):
                with tprof.span("work"):
                    torch.matmul(x, x)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    stem = traces[0][: -len(".pt.trace.json")]
    with open(tmp_path / traces[0]) as f:
        trace = json.load(f)
    with open(tmp_path / f"{stem}.spans.json") as f:
        spans = json.load(f)
    assert spans.get("baseTimeNanoseconds") == trace.get("baseTimeNanoseconds")
    events = {e["name"]: e for e in spans["traceEvents"]}
    assert set(events) == {"request", "work"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events.values())
    req, work = events["request"], events["work"]
    assert req["args"]["points"] == 64 and req["args"]["parent"] == 0
    assert work["args"]["parent"] == req["args"]["id"]
    assert work["args"]["root"] == req["args"]["id"]
    # one time axis: the profiler's range opened inside ``request`` and
    # closed around ``work``, to within 50 microseconds
    inside = next(e for e in trace["traceEvents"] if e.get("name") == "inside")
    slack = 50.0
    assert req["ts"] - slack <= inside["ts"] <= work["ts"] + slack
    assert (work["ts"] + work["dur"] - slack <= inside["ts"] + inside["dur"]
            <= req["ts"] + req["dur"] + slack)
