"""Milliseconds of host time in the Fourier embedding per value+grad: the
program's ``model.embed`` spans (the embedding's jet on the collocation
rows and its value on the source rows) over its ``vg`` spans, in the
traced run's profiled part.  None without such spans."""

from benchmark.program_spans import duration_s, profiled


def read(run):
    spans = profiled(run)
    if spans is None or not spans.get("vg") or not spans.get("model.embed"):
        return None
    return 1e3 * duration_s(spans["model.embed"]) / len(spans["vg"])
