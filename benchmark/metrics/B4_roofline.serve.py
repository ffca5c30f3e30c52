"""The composite forward (B4, ``composite_jet_kernel``) against its bound:
the order-1 forward of the three nets over the points answered while the
profiler ran (real points, not the chunks' padding), over the float32
peak, over its device time, in percent."""

from benchmark.core import kernel_seconds
from benchmark.flops import roofline


def read(run):
    t = run.device_trace
    if t is None:
        return None
    n, seconds = kernel_seconds(t, "composite_jet_kernel")
    points = (run.counts.get("profile_points1", 0)
              - run.counts.get("profile_points0", 0))
    if not n or not points:
        return None
    return 100.0 * roofline(run.flops["fwd"] * points,
                            run.flops["fwd_bytes"] * points, seconds)
