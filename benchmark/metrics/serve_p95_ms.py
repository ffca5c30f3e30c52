"""The 95th percentile (nearest rank) of the latency of every request of
the window, a failed one counting as beyond any limit."""

import math


def read(run):
    lat = sorted(s for _, s, _ in run.latencies)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
