"""The share of the rows the forward computes that are padding: the
``pad`` over the ``rows`` + ``pad`` of the program's ``render.chunk``
spans, in the traced run's profiled part, in percent."""

from benchmark.program_spans import profiled


def read(run):
    spans = profiled(run)
    chunks = spans.get("render.chunk") if spans is not None else None
    if not chunks:
        return None
    pad = sum(s.counts["pad"] for s in chunks)
    return 100.0 * pad / sum(s.counts["rows"] + s.counts["pad"]
                             for s in chunks)
