"""PyTorch port: the span recorder (``utils/profiling.py::span``) and the
spans of the optimizer, the value+grad and serving, on the CPU.

Spans are recorded only while a ``torch.profiler`` session records; each
test reads the records it made by their times."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pinn_elastodynamics_torch.eval.render import predict_fields
from pinn_elastodynamics_torch.models.fields import (
    SECOND_ORDER,
    FieldSpec,
    MLPFieldModel,
)
from pinn_elastodynamics_torch.serving import FieldEvaluator
from pinn_elastodynamics_torch.train.lbfgs import minimize
from pinn_elastodynamics_torch.utils import profiling

CHUNK = 64
RENDER = ("render.chunk", "render.h2d", "render.jet", "render.d2h",
          "render.merge")


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _since(t0):
    return [s for s in profiling.spans() if s.start >= t0]


def _named(records, name):
    return [s for s in records if s.name == name]


def _quadratic(p):
    a = torch.linspace(1.0, 20.0, p["x"].numel(), dtype=p["x"].dtype)
    return 0.5 * torch.sum(a * p["x"] ** 2)


def _rosenbrock(p):
    x = p["x"]
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, p):
        self.calls += 1
        return self.fn(p)


@pytest.mark.parametrize("name,counts", [
    ("lbfgs.minimize", {}), ("render.chunk", {"rows": 3, "pad": 1}),
    ("serve.evaluate", {"points": 7})])
def test_span_is_the_shared_no_op_outside_a_profiler(name, counts):
    t0 = time.perf_counter()
    sp = profiling.span(name, **counts)
    assert sp is profiling.NO_SPAN
    with sp as entered:
        assert entered is profiling.NO_SPAN
    assert _since(t0) == []


def _run_minimize():
    minimize(_rosenbrock, {"x": torch.zeros(4, dtype=torch.float64)},
             maxiter=3)


def _run_render():
    predict_fields(_model(), _params(), np.zeros((5, 2), np.float32), 0.5,
                   chunk=CHUNK, device="cpu")


@pytest.mark.parametrize("work", [_run_minimize, _run_render])
def test_nothing_is_recorded_outside_a_profiler(work):
    t0 = time.perf_counter()
    work()
    assert _since(t0) == []


def test_spans_nest_under_a_profiler():
    t0 = time.perf_counter()
    with _profiler():
        with profiling.span("outer", points=3) as outer:
            with profiling.span("inner") as inner:
                with profiling.span("leaf", pad=1):
                    pass
            with profiling.span("sibling"):
                pass
        with profiling.span("next"):
            pass
    by = {s.name: s for s in _since(t0)}
    assert set(by) == {"outer", "inner", "leaf", "sibling", "next"}
    assert by["outer"].id == outer.id and by["inner"].id == inner.id
    assert by["outer"].parent == 0 and by["outer"].root == outer.id
    assert by["inner"].parent == outer.id and by["sibling"].parent == outer.id
    assert by["leaf"].parent == inner.id
    assert {by[n].root for n in ("inner", "leaf", "sibling")} == {outer.id}
    assert by["next"].parent == 0 and by["next"].root == by["next"].id
    assert by["outer"].counts == {"points": 3} and by["leaf"].counts == {
        "pad": 1}
    o, i, leaf = by["outer"], by["inner"], by["leaf"]
    assert o.start <= i.start <= leaf.start <= leaf.end <= i.end <= o.end
    # children close first
    names = [s.name for s in _since(t0)]
    assert names.index("leaf") < names.index("inner") < names.index("outer")


def test_each_thread_has_its_own_stack():
    t0 = time.perf_counter()
    both_open = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            both_open.wait()
            with profiling.span(f"{tag}.inner"):
                both_open.wait()

    with _profiler():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in _since(t0)}
    for tag in "ab":
        outer, inner = by[f"{tag}.outer"], by[f"{tag}.inner"]
        assert outer.parent == 0 and inner.parent == outer.id
        assert inner.root == outer.id and inner.thread == outer.thread
    assert by["a.outer"].thread != by["b.outer"].thread


def test_a_span_closes_when_its_block_raises():
    t0 = time.perf_counter()
    with _profiler():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("raises"):
                    raise ValueError("boom")
        with profiling.span("after"):
            pass
    by = {s.name: s for s in _since(t0)}
    assert by["raises"].parent == by["outer"].id
    assert by["after"].parent == 0


def test_the_buffer_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder(4))
    with _profiler():
        for k in range(10):
            with profiling.span("s", k=k):
                pass
    assert [s.counts["k"] for s in profiling.spans()] == [6, 7, 8, 9]


@pytest.mark.parametrize("fn,segment", [
    (_quadratic, 1), (_quadratic, 4), (_rosenbrock, 1), (_rosenbrock, 3),
    (_rosenbrock, 100), (_quadratic, 100)])
def test_minimize_spans_count_its_work(fn, segment):
    """From a carry (no seed evaluation): one ``lbfgs.trial`` per
    value+grad, one ``lbfgs.iteration`` per iteration, and iterates
    bitwise those of the run without a profiler."""
    start = {"x": torch.linspace(-1.2, 1.0, 6, dtype=torch.float64)}
    carry = minimize(fn, start, maxiter=0, memory_size=3).carry
    kw = dict(maxiter=8, memory_size=3, segment=segment, init_carry=carry)
    plain = minimize(fn, carry[0], **kw)
    counted = _Counting(fn)
    t0 = time.perf_counter()
    with _profiler():
        traced = minimize(counted, carry[0], **kw)
    rec = _since(t0)
    assert torch.equal(traced.params["x"], plain.params["x"])
    np.testing.assert_array_equal(traced.loss_history, plain.loss_history)
    assert len(_named(rec, "lbfgs.minimize")) == 1
    assert len(_named(rec, "lbfgs.iteration")) == traced.n_iters
    for name in ("lbfgs.trial", "vg", "vg.forward", "vg.backward"):
        assert len(_named(rec, name)) == counted.calls
    pairs = [s.counts["pairs"] for s in _named(rec, "lbfgs.direction")]
    assert pairs == [min(k, 3) for k in range(traced.n_iters)]
    # reads: the resume check, one per trial and iteration, one history
    # per segment
    segments = -(-traced.n_iters // min(segment, 8))
    assert len(_named(rec, "lbfgs.read")) == (
        1 + counted.calls + traced.n_iters + segments)
    top = _named(rec, "lbfgs.minimize")[0]
    assert all(s.root == top.id for s in rec)
    ids = {s.id: s for s in rec}
    for s in _named(rec, "vg"):
        assert ids[s.parent].name == "lbfgs.trial"
    for s in _named(rec, "lbfgs.trial"):
        assert ids[s.parent].name == "lbfgs.iteration"


def _model():
    return MLPFieldModel(spec=FieldSpec(ndim=2, formulation=SECOND_ORDER),
                         hidden=(8, 8))


def _params():
    return _model().init(torch.Generator().manual_seed(5), torch.float32,
                         "cpu")


@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1, 5 * CHUNK - 3])
def test_predict_fields_spans_each_chunk(n):
    xy = np.random.default_rng(n).uniform(0, 1, (n, 2)).astype(np.float32)
    plain = predict_fields(_model(), _params(), xy, 0.5, chunk=CHUNK,
                           device="cpu")
    t0 = time.perf_counter()
    with _profiler():
        traced = predict_fields(_model(), _params(), xy, 0.5, chunk=CHUNK,
                                device="cpu")
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k])
    rec = _since(t0)
    chunks = _named(rec, "render.chunk")
    assert len(chunks) == -(-n // CHUNK)
    assert sum(s.counts["rows"] for s in chunks) == n
    assert [s.counts["pad"] for s in chunks] == (
        [0] * (len(chunks) - 1) + [len(chunks) * CHUNK - n])
    for name in ("render.h2d", "render.jet", "render.d2h"):
        parents = [s.parent for s in _named(rec, name)]
        assert parents == [s.id for s in chunks]
    assert len(_named(rec, "render.merge")) == 1


@pytest.mark.parametrize("sizes", [(3, 2 * CHUNK + 5), (CHUNK, 1, CHUNK + 9)])
def test_evaluate_spans_carry_the_request_id(sizes):
    ev = FieldEvaluator(_model(), _params(), chunk=CHUNK, device="cpu")
    rng = np.random.default_rng(len(sizes))
    t0 = time.perf_counter()
    with _profiler():
        for n in sizes:
            ev.evaluate(rng.uniform(0, 1, (n, 2)), 1.0)
    rec = _since(t0)
    requests = _named(rec, "serve.evaluate")
    assert [s.counts["points"] for s in requests] == list(sizes)
    assert all(s.parent == 0 and s.root == s.id for s in requests)
    for req in requests:
        mine = [s for s in rec if s.root == req.id and s is not req]
        assert {s.name for s in mine} == set(RENDER)
        assert all(req.start <= s.start <= s.end <= req.end for s in mine)
        chunks = _named(mine, "render.chunk")
        assert sum(s.counts["rows"] for s in chunks) == req.counts["points"]
        assert sum(s.counts["rows"] + s.counts["pad"] for s in chunks) == (
            CHUNK * len(chunks))
    assert len(rec) == sum(1 + 4 * -(-n // CHUNK) + 1 for n in sizes)
