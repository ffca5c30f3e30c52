"""Milliseconds of host time in the closed-form hard-BC factors per
value+grad: the program's ``model.factors`` spans (D's and P's jets on the
collocation rows, their values on the source rows) over its ``vg`` spans,
in the traced run's profiled part.  None without such spans."""

from benchmark.program_spans import duration_s, profiled


def read(run):
    spans = profiled(run)
    if spans is None or not spans.get("vg") or not spans.get("model.factors"):
        return None
    return 1e3 * duration_s(spans["model.factors"]) / len(spans["vg"])
