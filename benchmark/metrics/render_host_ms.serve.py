"""Milliseconds of a frame-sized request not spent copying fields back:
the median, over the program's ``serve.evaluate`` spans of
``frame_points`` points, of the time covered by none of that request's
``render.d2h`` spans, in the traced run's profiled part."""

from benchmark.program_spans import frames, median_ms


def read(run):
    found = frames(run)
    return None if found is None else median_ms(found[1])
