"""The median latency of the frame-sized requests of the traced run's
plain part, in milliseconds (a steadier statistic beside the tail)."""

import statistics


def read(run):
    end = run.counts.get("plain_end", float("inf"))
    frames = [s for kind, s, t in run.latencies
              if kind == "frame" and t < end]
    return 1e3 * statistics.median(frames) if frames else None
