"""Share of the program's ``render.chunk`` spans in the traced run's
profiled part that ran the chunk's forward as a replay of its CUDA graph
(the span's ``graph`` count is 1), in %.  None where the spans carry no
such count: a program whose chunks have no graph."""

from benchmark.program_spans import profiled


def read(run):
    spans = profiled(run)
    if spans is None:
        return None
    graph = [s.counts.get("graph") for s in spans.get("render.chunk", ())]
    if not graph or None in graph:
        return None
    return 100.0 * sum(graph) / len(graph)
