"""PyTorch port: ``FieldEvaluator``'s chunks as replays of a CUDA graph
(serving.py), and the eager path every other evaluator keeps.

The CPU tests check that a CPU evaluator serves eagerly and says so in
``CHUNKS`` and in its ``render.chunk`` spans, that every answer owns its
arrays and that the evaluator's parameters are its own.  The ``card``
tests hold the replayed answers to the eager ``predict_fields``, bitwise,
for the net-BC plate (B4) and the analytic + Fourier64 plate (B1's seeded
forward and plain ops for D and P); check that replayed answers own their
arrays too, and survive the allocator handing freed memory to others;
count one capture per evaluator and the launches of each
request; keep a hard-BC model's stored factors out of the graph; fall
back to eager where the capture raises; and serve two HTTP threads the
same bits.  This file imports no JAX, so the card tests run
on a machine without it:

    python -m pytest --noconftest tests/test_torch_serve_graph.py -q
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pinn_elastodynamics_torch import serving
from pinn_elastodynamics_torch.cases import plate_hole
from pinn_elastodynamics_torch.eval.render import predict_fields
from pinn_elastodynamics_torch.kernels import fused_jet
from pinn_elastodynamics_torch.models import analytic_bc
from pinn_elastodynamics_torch.models.analytic_bc import FACTOR_JETS
from pinn_elastodynamics_torch.models.fields import (
    SECOND_ORDER,
    FieldSpec,
    MLPFieldModel,
)
from pinn_elastodynamics_torch.serving import (
    CHUNKS,
    FieldEvaluator,
    FieldServer,
)
from pinn_elastodynamics_torch.utils import profiling

CHUNK = 64
T = 1.25
FRAME = 37_811   # the FEM probe grid's points


def _points(n, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 0.5, (n, 2)).astype(
        np.float32)


def _small():
    return MLPFieldModel(spec=FieldSpec(ndim=2, formulation=SECOND_ORDER),
                         hidden=(8, 8))


def _init(model, device):
    return model.init(torch.Generator().manual_seed(7), torch.float32,
                      device)


@pytest.fixture
def fresh_chunks():
    serving.reset_chunks()


@pytest.mark.parametrize("sizes", [(1,), (CHUNK, CHUNK + 1), (3, 5 * CHUNK - 2)])
def test_cpu_evaluator_serves_eagerly(fresh_chunks, sizes):
    """Every chunk of a CPU evaluator is eager, and its ``render.chunk``
    spans carry ``graph`` = 0."""
    ev = FieldEvaluator(_small(), _init(_small(), "cpu"), chunk=CHUNK,
                        device="cpu").warmup()
    assert CHUNKS == {"graph": 0, "eager": 1, "captures": 0,
                      "capture_errors": 0}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for n in sizes:
            ev.evaluate(_points(n), T)
    chunks = [s for s in profiling.spans()
              if s.name == "render.chunk" and s.start >= t0]
    n_chunks = sum(-(-n // CHUNK) for n in sizes)
    assert [s.counts["graph"] for s in chunks] == [0] * n_chunks
    assert CHUNKS == {"graph": 0, "eager": 1 + n_chunks, "captures": 0,
                      "capture_errors": 0}


@pytest.mark.parametrize("first,second", [(5, 5), (CHUNK + 3, 2 * CHUNK),
                                          (2 * CHUNK, 1)])
def test_answers_own_their_arrays(first, second):
    """A later request leaves an earlier answer's arrays as they were."""
    ev = FieldEvaluator(_small(), _init(_small(), "cpu"), chunk=CHUNK,
                        device="cpu")
    answer = ev.evaluate(_points(first, seed=1), T)
    kept = {k: v.copy() for k, v in answer.items()}
    ev.evaluate(_points(second, seed=2), 2.0 * T)
    for k, v in kept.items():
        np.testing.assert_array_equal(answer[k], v)


def test_evaluator_params_are_its_own():
    """An in-place change to the caller's tensors changes no answer."""
    params = _init(_small(), "cpu")
    ev = FieldEvaluator(_small(), params, chunk=CHUNK, device="cpu")
    xy = _points(2 * CHUNK + 1)
    before = ev.evaluate(xy, T)
    for layer in params:
        layer["W"].mul_(2.0)
        layer["b"].add_(1.0)
    after = ev.evaluate(xy, T)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


# -- on the card --------------------------------------------------------------

MODELS = {
    "net_bc": lambda: plate_hole.build_model(),
    "analytic_fourier64": lambda: plate_hole.build_model(
        bc="analytic", fourier=64, fourier_scale=2.0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def _eager(ev, xy, t):
    return predict_fields(ev.model, ev.params, xy, t, chunk=ev.chunk,
                          device=ev.device)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.card
@pytest.mark.parametrize("name", MODELS)
def test_replay_bitwise_equals_eager(card, fresh_chunks, name):
    """A 1-point request, exactly one chunk and a frame: the replayed
    answers are the eager ``predict_fields``'s bits; one capture."""
    model = MODELS[name]()
    ev = FieldEvaluator(model, _init(model, card), device=card)
    sizes = (1, ev.chunk, FRAME)
    for n in sizes:
        xy = _points(n, seed=n)
        _assert_same(ev.evaluate(xy, T), _eager(ev, xy, T))
    assert CHUNKS == {"graph": sum(-(-n // ev.chunk) for n in sizes),
                      "eager": 0, "captures": 1, "capture_errors": 0}


@pytest.mark.card
def test_replayed_answers_own_their_arrays(card, fresh_chunks):
    """On the graph path too, a later request leaves an earlier answer as
    it was, and no answer shares memory with the evaluator's buffers."""
    model = MODELS["net_bc"]()
    ev = FieldEvaluator(model, _init(model, card), device=card)
    answers = [ev.evaluate(_points(n, seed=n), T) for n in (FRAME, 1)]
    kept = [{k: v.copy() for k, v in a.items()} for a in answers]
    ev.evaluate(_points(FRAME, seed=3), 2.0 * T)
    for answer, copies in zip(answers, kept):
        for k, v in answer.items():
            np.testing.assert_array_equal(v, copies[k])
            for buf in (ev._points, ev._fields):
                assert not np.shares_memory(v, buf.numpy())
    assert CHUNKS["graph"] == 5 + 1 + 5


@pytest.mark.card
def test_replays_survive_memory_churn(card, fresh_chunks):
    """The graph holds what its replays read: after the allocator's cache
    is emptied and memory is taken and filled with NaN on the default
    stream and on each of the 32 pooled side streams (one of which the
    capture ran on), a replayed answer is still the eager bits."""
    model = MODELS["analytic_fourier64"]()
    ev = FieldEvaluator(model, _init(model, card), device=card).warmup()
    xy = _points(FRAME, seed=11)
    want = _eager(ev, xy, T)
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    held = []
    streams = [torch.cuda.current_stream(card)]
    streams += [torch.cuda.Stream(card) for _ in range(32)]
    for stream in streams:
        with torch.cuda.stream(stream):
            held += [torch.full((n % 128 + 1,), float("nan"), device=card)
                     for n in range(2048)]
            held.append(torch.full((1 << 22,), float("nan"), device=card))
    torch.cuda.synchronize(card)
    _assert_same(ev.evaluate(xy, T), want)
    _assert_same(_eager(ev, xy, T), want)
    assert CHUNKS["captures"] == 1 and CHUNKS["eager"] == 0


@pytest.mark.card
def test_graph_computes_the_factors_from_its_input(card, fresh_chunks):
    """A hard-BC model's closed-form factors stay out of the graph: the
    capture stores none (one ``bypass`` in ``FACTOR_JETS``), so two
    different requests in a row each get the eager bits."""
    model = MODELS["analytic_fourier64"]()
    ev = FieldEvaluator(model, _init(model, card), device=card)
    analytic_bc.reset_factor_jets()
    requests = [(_points(FRAME, seed=21), T), (_points(5_000, seed=22), 2 * T)]
    answers = [ev.evaluate(xy, t) for xy, t in requests]
    # the warm-up on the graph's input stores; the capture bypasses
    assert FACTOR_JETS == {"hit": 0, "miss": 1, "bypass": 1}
    for got, (xy, t) in zip(answers, requests):
        _assert_same(got, _eager(ev, xy, t))
    assert CHUNKS["captures"] == 1 and CHUNKS["eager"] == 0


@pytest.mark.card
def test_one_capture_per_evaluator(card, fresh_chunks):
    """Two evaluators capture once each, however many requests they serve;
    their ``render.chunk`` spans carry ``graph`` = 1 and each request has
    one ``render.d2h``."""
    evs = [FieldEvaluator(MODELS[name](), _init(MODELS[name](), card),
                          device=card).warmup() for name in MODELS]
    assert CHUNKS["captures"] == 2
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for ev in evs:
            for n in (3, 20_000, 5):
                ev.evaluate(_points(n), T)
    spans = [s for s in profiling.spans() if s.start >= t0]
    chunks = [s for s in spans if s.name == "render.chunk"]
    assert [s.counts["graph"] for s in chunks] == [1] * 2 * (1 + 3 + 1)
    assert sum(s.name == "render.d2h" for s in spans) == 2 * 3
    assert CHUNKS == {"graph": 2 + 2 * 5, "eager": 0, "captures": 2,
                      "capture_errors": 0}


@pytest.mark.card
@pytest.mark.parametrize("name,kernel", [("net_bc", "fused_composite_jet"),
                                         ("analytic_fourier64",
                                          "fused_mlp_jet")])
def test_launches_grow_as_eager(card, fresh_chunks, name, kernel):
    """A replayed request adds to ``LAUNCHES`` what the eager one adds."""
    model = MODELS[name]()
    ev = FieldEvaluator(model, _init(model, card), device=card).warmup()
    for n in (1, 3 * ev.chunk + 1):
        xy = _points(n)
        before = dict(fused_jet.LAUNCHES)
        ev.evaluate(xy, T)
        replayed = {k: fused_jet.LAUNCHES[k] - before[k] for k in before}
        before = dict(fused_jet.LAUNCHES)
        _eager(ev, xy, T)
        eager = {k: fused_jet.LAUNCHES[k] - before[k] for k in before}
        assert replayed == eager
        assert replayed[kernel] == -(-n // ev.chunk)


@pytest.mark.card
def test_capture_error_serves_eagerly(card, fresh_chunks, monkeypatch):
    """A capture that raises is counted; the evaluator serves every request
    eagerly, with the eager bits, and fails none."""
    def broken(*args, **kwargs):
        raise RuntimeError("planted capture fault")

    monkeypatch.setattr(serving, "_ChunkGraph", broken)
    model = MODELS["net_bc"]()
    ev = FieldEvaluator(model, _init(model, card), device=card)
    with pytest.warns(UserWarning, match="planted capture fault"):
        ev.warmup()
    for n in (1, 2 * ev.chunk + 7):
        xy = _points(n)
        _assert_same(ev.evaluate(xy, T), _eager(ev, xy, T))
    assert CHUNKS == {"graph": 0, "eager": 1 + 1 + 3, "captures": 0,
                      "capture_errors": 1}


def _post(address, xy):
    host, port = address
    req = urllib.request.Request(
        f"http://{host}:{port}/predict",
        data=json.dumps({"points": xy.tolist(), "t": T}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["fields"]


@pytest.mark.card
def test_two_server_threads_same_bits(card, fresh_chunks):
    """Two HTTP threads asking at once get the same bits as each other and
    as a direct request."""
    model = MODELS["net_bc"]()
    ev = FieldEvaluator(model, _init(model, card), device=card).warmup()
    requests = [_points(n, seed=n) for n in (1, 9_000, 300)]
    answers = [[], []]
    server = FieldServer(ev).start()
    try:
        def client(out):
            for _ in range(3):
                for xy in requests:
                    out.append(_post(server.address, xy))

        threads = [threading.Thread(target=client, args=(a,))
                   for a in answers]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    finally:
        server.stop()
    assert len(answers[0]) == len(answers[1]) == 3 * len(requests)
    for i, got in enumerate(answers[0]):
        direct = ev.evaluate(requests[i % len(requests)], T)
        for other in (got, answers[1][i]):
            _assert_same({k: np.asarray(v, np.float32)
                          for k, v in other.items()}, direct)
    assert CHUNKS["captures"] == 1 and CHUNKS["eager"] == 0
