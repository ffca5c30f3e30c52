"""The whole request path's share of the card's float32 peak: the
order-1 composite forward's operations per point times the points
answered in the traced run's plain part (nothing added), over that part's
seconds and the peak, in percent."""

from benchmark.flops import F32_PEAK_FLOPS


def read(run):
    c = run.counts
    if not c.get("plain_points"):
        return None
    rate = run.flops["fwd"] * c["plain_points"] / (c["plain_end"]
                                                  - c["window_start"])
    return 100.0 * rate / (F32_PEAK_FLOPS * run.chips)
