"""Milliseconds of host time of one value+grad, unsynchronised: the mean
of the program's ``vg`` spans (building the forward and enqueuing the
backward), in the traced run's profiled part."""

from benchmark.program_spans import duration_s, profiled


def read(run):
    spans = profiled(run)
    if spans is None or not spans.get("vg"):
        return None
    return 1e3 * duration_s(spans["vg"]) / len(spans["vg"])
