"""Milliseconds of host time in the MLP's input normalisation per
value+grad: the program's ``model.normalize`` spans (the normalised seed
of the collocation jet, forward and backward, and the plain forwards'
normalised inputs, each with its synchronous lb/ub copies) over its ``vg``
spans, in the traced run's profiled part.  None without such spans."""

from benchmark.program_spans import duration_s, profiled


def read(run):
    spans = profiled(run)
    if (spans is None or not spans.get("vg")
            or not spans.get("model.normalize")):
        return None
    return 1e3 * duration_s(spans["model.normalize"]) / len(spans["vg"])
