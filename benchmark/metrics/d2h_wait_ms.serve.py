"""Milliseconds a frame-sized request spends in ``render.d2h``: the
fields' copies back to the host, the first of each chunk waiting for the
forward; the median over the program's ``serve.evaluate`` spans of
``frame_points`` points, in the traced run's profiled part."""

from benchmark.program_spans import frames, median_ms


def read(run):
    found = frames(run)
    if found is None:
        return None
    requests, host = found
    return median_ms([s.end - s.start - h for s, h in zip(requests, host)])
