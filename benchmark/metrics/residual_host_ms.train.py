"""Milliseconds of host time in the PDE residual per value+grad: the
program's ``loss.residual`` spans (the residuals from the collocation
jet and their masked sums) over its ``vg`` spans, in the traced run's
profiled part.  None without such spans."""

from benchmark.program_spans import duration_s, profiled


def read(run):
    spans = profiled(run)
    if spans is None or not spans.get("vg") or not spans.get("loss.residual"):
        return None
    return 1e3 * duration_s(spans["loss.residual"]) / len(spans["vg"])
