"""``serve_graph_share.serve`` on synthetic spans: the share of
``render.chunk`` spans in the profiled part with ``graph`` = 1, and nothing
(None, no error) where the spans lack the count, as a program whose chunks
have no graph records them."""

import pytest

from benchmark.core import metric_reader
from benchmark.tests.test_bench_spans import END, START, _run, _Tree
from benchmark.tests.test_bench_spans import recorded  # noqa: F401

NAME = "serve_graph_share.serve"


def _request(at: float, ids: list, graph: list) -> list:
    """One request, a chunk per entry of ``graph``: its ``render.chunk``
    span's ``graph`` count, or no such count where the entry is None."""
    t = _Tree(at, ids)
    req = t.add("serve.evaluate", 0, 2 * len(graph) + 2, points=100)
    for k, flag in enumerate(graph):
        counts = {"rows": 50, "pad": 14}
        if flag is not None:
            counts["graph"] = flag
        c = t.add("render.chunk", 2 * k, 2 * k + 1, req, **counts)
        t.add("render.h2d", 2 * k, 2 * k + 0.5, c)
        t.add("render.jet", 2 * k + 0.5, 2 * k + 1, c)
    t.add("render.d2h", 2 * len(graph), 2 * len(graph) + 1, req)
    t.add("render.merge", 2 * len(graph) + 1, 2 * len(graph) + 2, req)
    return t.out


@pytest.mark.parametrize("inside,share", [
    ([[1, 1], [1]], 100.0), ([[0], [0, 0, 0]], 0.0), ([[1, 0], [1, 1]], 75.0)])
def test_share_of_replayed_chunks(recorded, inside, share):
    ids = [0]
    # requests before and after the profiled part are left out
    recorded += _request(START - 1.0, ids, [0, 0])
    for k, graph in enumerate(inside):
        recorded += _request(START + 1.0 + k, ids, graph)
    recorded += _request(END + 1.0, ids, [0])
    assert metric_reader(NAME)(_run()) == pytest.approx(share)


def test_nothing_to_read_gives_none(recorded):
    run = _run()
    assert metric_reader(NAME)(run) is None           # no span recorded
    recorded += _request(START - 1.0, [0], [1, 1])
    assert metric_reader(NAME)(run) is None           # none in the part
    recorded += _request(START + 1.0, [100], [None, None])
    assert metric_reader(NAME)(run) is None           # no graph count
    recorded += _request(START + 2.0, [200], [1, 1])
    assert metric_reader(NAME)(run) is None           # some without it
    untraced = _run()
    del untraced.counts["spans_start"]
    assert metric_reader(NAME)(untraced) is None      # no profiled part
