"""The readers of the program's spans, on a synthetic run: each reads only
the spans of the profiled part, and reads nothing (None, no error) from a
program without the recorder or a run with no span there."""

import time

import pytest
import torch

from benchmark.core import Run, metric_reader
from pinn_elastodynamics_torch.utils import profiling
from pinn_elastodynamics_torch.utils.profiling import SpanRecord

TRAIN = ("lbfgs_self_ms.train", "lbfgs_direction_ms.train",
         "lbfgs_wait_ms.train", "ls_trials_per_iter.train",
         "vg_host_ms.train")
SERVE = ("render_host_ms.serve", "d2h_wait_ms.serve", "pad_share.serve")
START, END = 100.0, 200.0


def _run(**traffic) -> Run:
    run = Run(cell={"name": "synthetic"}, config={}, traffic=traffic,
              seed=1, seconds=1.0, trace=True, device=torch.device("cpu"),
              chips=1, t_start=time.perf_counter(), limits={})
    run.counts.update(plain_end=START, spans_start=END)
    return run


class _Tree:
    """Spans of one root, ids in order, times in ms from ``at``."""

    def __init__(self, at: float, ids: list):
        self.at, self.ids, self.out = at, ids, []
        self.root = None

    def add(self, name, t0_ms, t1_ms, parent=None, **counts):
        sid = self.ids[0] = self.ids[0] + 1
        self.root = self.root or sid
        self.out.append(SpanRecord(
            name, self.at + t0_ms * 1e-3, self.at + t1_ms * 1e-3, sid,
            parent or 0, self.root, 1, counts))
        return sid


def _minimize(at: float, ids: list) -> list:
    """Two iterations: the first with two trials, the second with one."""
    t = _Tree(at, ids)
    top = t.add("lbfgs.minimize", 0, 100)
    it = t.add("lbfgs.iteration", 1, 60, top)
    t.add("lbfgs.direction", 1, 11, it, pairs=50)
    tr = t.add("lbfgs.trial", 12, 35, it)
    t.add("vg", 12, 20, tr)
    t.add("lbfgs.read", 20, 30, tr)
    tr = t.add("lbfgs.trial", 35, 55, it)
    t.add("vg", 35, 43, tr)
    t.add("lbfgs.read", 43, 50, tr)
    t.add("lbfgs.read", 57, 59, it)
    it = t.add("lbfgs.iteration", 60, 95, top)
    t.add("lbfgs.direction", 60, 68, it, pairs=50)
    tr = t.add("lbfgs.trial", 70, 90, it)
    t.add("vg", 70, 76, tr)
    t.add("lbfgs.read", 76, 85, tr)
    t.add("lbfgs.read", 92, 93, it)
    t.add("lbfgs.read", 96, 99, top)
    return t.out


def _request(at: float, ids: list, points: int, chunk: int,
             d2h_ms: float) -> list:
    t = _Tree(at, ids)
    n = -(-points // chunk)
    req = t.add("serve.evaluate", 0, 1.5 + n * (1 + d2h_ms), points=points)
    t0, left = 0.5, points
    while left > 0:
        rows = min(chunk, left)
        c = t.add("render.chunk", t0, t0 + 1 + d2h_ms, req, rows=rows,
                  pad=chunk - rows)
        t.add("render.h2d", t0, t0 + 0.2, c)
        t.add("render.jet", t0 + 0.2, t0 + 1, c)
        t.add("render.d2h", t0 + 1, t0 + 1 + d2h_ms, c)
        t0 += 1 + d2h_ms
        left -= rows
    t.add("render.merge", t0, t0 + 0.5, req)
    return t.out


@pytest.fixture
def recorded(monkeypatch):
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return records


def test_training_readers(recorded):
    ids = [0]
    # one call inside the part, one before it and one after: left out
    recorded += (_minimize(START - 1.0, ids) + _minimize(START + 1.0, ids)
                 + _minimize(END - 0.05, ids))
    run = _run()
    read = {name: metric_reader(name)(run) for name in TRAIN}
    # minimize 100 ms, less vg 8 + 8 + 6 and reads 10 + 7 + 2 + 9 + 1 + 3
    assert read["lbfgs_self_ms.train"] == pytest.approx((100 - 22 - 32) / 2)
    assert read["lbfgs_direction_ms.train"] == pytest.approx((10 + 8) / 2)
    assert read["lbfgs_wait_ms.train"] == pytest.approx(32 / 2)
    assert read["ls_trials_per_iter.train"] == 1.5
    assert read["vg_host_ms.train"] == pytest.approx(22 / 3)
    for name in TRAIN:
        twin = metric_reader(f"{name}.wave_confined")(run)
        assert twin == read[name]


def test_serving_readers(recorded):
    ids = [0]
    recorded += (_request(START + 1.0, ids, 300, 128, 2.0)
                 + _request(START + 2.0, ids, 300, 128, 4.0)
                 + _request(START + 3.0, ids, 300, 128, 3.0)
                 + _request(START + 4.0, ids, 5, 128, 1.0)
                 + _request(START - 1.0, ids, 300, 128, 9.0))
    run = _run(frame_points=300)
    # frames: 3 chunks each, d2h 6, 12 and 9 ms, 4.5 ms of the rest
    assert metric_reader("d2h_wait_ms.serve")(run) == pytest.approx(9.0)
    assert metric_reader("render_host_ms.serve")(run) == pytest.approx(4.5)
    pad = 3 * (3 * 128 - 300) + 123
    assert metric_reader("pad_share.serve")(run) == pytest.approx(
        100.0 * pad / (3 * 3 * 128 + 128))


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_nothing_to_read_gives_none(recorded, monkeypatch, name):
    run = _run(frame_points=300)
    assert metric_reader(name)(run) is None           # no span recorded
    recorded += _minimize(START - 1.0, [0]) + _request(END + 1.0, [100], 300,
                                                       128, 2.0)
    assert metric_reader(name)(run) is None           # none in the part
    recorded += _minimize(START + 1.0, [200]) + _request(START + 2.0, [300],
                                                         300, 128, 2.0)
    assert metric_reader(name)(run) is not None
    untraced = _run(frame_points=300)
    del untraced.counts["spans_start"]
    assert metric_reader(name)(untraced) is None      # no profiled part
    monkeypatch.delattr(profiling, "spans")           # a parent program
    assert metric_reader(name)(run) is None
