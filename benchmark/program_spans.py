"""The program's own spans (``pinn_elastodynamics_torch/utils/profiling.py``)
in a traced run's profiled part, for the metric readers.

The program records spans only while a ``torch.profiler`` session records:
in a traced run, the ``profile`` part, between ``counts["plain_end"]`` and
``counts["spans_start"]``, the seconds the device metrics describe.  The
parts change between calls of ``minimize`` and between requests; a tree
of spans (a call or a request and the spans under it) is read when its
outermost span lies in the part.  A program without the recorder, or a run
with no span in the part, gives None.
"""

from __future__ import annotations

import collections
import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def profiled(run) -> Optional[Dict[str, list]]:
    """The spans of the profiled part by name, or None."""
    start, end = run.counts.get("plain_end"), run.counts.get("spans_start")
    if start is None or end is None:
        return None
    try:
        from pinn_elastodynamics_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    records = read()
    inside = {s.id for s in records
              if s.parent == 0 and s.start >= start and s.end <= end}
    by_name = collections.defaultdict(list)
    for s in records:
        if s.root in inside:
            by_name[s.name].append(s)
    return by_name or None


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def uncovered_s(outer, inner) -> List[float]:
    """For each span of ``outer``: its seconds covered by none of the
    spans of ``inner`` under the same root (the same request or call)."""
    by_root = collections.defaultdict(list)
    for s in inner:
        by_root[s.root].append((s.start, s.end))
    out = []
    for o in outer:
        clipped = [(max(a, o.start), min(b, o.end))
                   for a, b in by_root.get(o.root, ()) if b > o.start
                   and a < o.end]
        out.append(o.end - o.start - union_s(clipped))
    return out


def per_iteration_ms(run, seconds) -> Optional[float]:
    """``seconds(spans by name)`` per ``lbfgs.iteration``, in ms."""
    spans = profiled(run)
    if spans is None or not spans.get("lbfgs.iteration"):
        return None
    return 1e3 * seconds(spans) / len(spans["lbfgs.iteration"])


def duration_s(spans: list) -> float:
    return sum(s.end - s.start for s in spans)


def frames(run) -> Optional[Tuple[list, list]]:
    """The frame-sized requests (``serve.evaluate`` spans with ``points`` =
    the traffic's ``frame_points``) and, for each, its seconds covered by
    none of its ``render.d2h`` spans; None without such a request."""
    spans = profiled(run)
    if spans is None:
        return None
    size = run.traffic["frame_points"]
    requests = [s for s in spans.get("serve.evaluate", ())
                if s.counts.get("points") == size]
    if not requests:
        return None
    return requests, uncovered_s(requests, spans.get("render.d2h", ()))


def median_ms(values: list) -> float:
    return 1e3 * statistics.median(values)
