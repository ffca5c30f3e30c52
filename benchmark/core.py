"""What every cell of the benchmark shares: the run's record, host spans,
the device trace and its reduction, the card's identity and the result
line.

Nothing here imports the program or the benchmark's reference.  Times are
host-clock seconds (``time.perf_counter``) unless a name says otherwise;
device times come from ``torch.profiler`` (CUPTI), mapped onto the host
clock by a marker recorded at a known host time.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "pinn_elastodynamics_tpu")
MARK = "benchmark.mark"
TOP = 10   # entries of each list of the breakdown
METRICS = Path(__file__).resolve().parent / "metrics"


def metric_reader(name: str) -> Callable:
    """The ``read(run)`` of ``benchmark/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host intervals by name, appended from any thread."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = (
            collections.defaultdict(list))

    def add(self, name: str, t0: float, t1: float) -> None:
        self.by_name[name].append((t0, t1))

    def name_at(self, t: float, default: str) -> str:
        """The name of a span open at host time ``t``, else ``default``."""
        for name, spans in self.by_name.items():
            for t0, t1 in spans:
                if t0 <= t < t1:
                    return name
        return default


class Run:
    """One run of one cell: what the drivers record and the metric readers
    read.  ``counts`` holds the work done in the window, ``flops`` the
    operations the adapter counted from shapes, ``device_trace`` the
    reduction of the device trace (traced runs only)."""

    def __init__(self, *, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 chips: int, t_start: float, limits: dict):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.chips, self.t_start = device, chips, t_start
        self.limits = limits
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.counts: Dict[str, float] = collections.defaultdict(float)
        self.flops: Dict[str, float] = {}
        self.spans = Spans()
        self.latencies: List[Tuple[str, float, float]] = []  # kind, s, start
        self.device_trace: Optional[dict] = None
        self.memory_peak_bytes: int = 0
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.attempted = 0
        self.failed = 0

    def mark_setup_done(self) -> float:
        self.setup_s = time.perf_counter() - self.t_start
        return self.setup_s

    def check(self, name: str, value: float) -> None:
        """Record one compared number beside its limit (the cell's file
        under ``benchmark/limits``)."""
        self.checks[name] = (float(value), float(self.limits[name]))

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.failed == 0
                and all(v <= lim for v, lim in self.checks.values()))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- the device trace ---------------------------------------------------------

class DeviceTrace:
    """``torch.profiler`` over part of the window, reduced to device busy
    time, per-kernel device time and the idle gaps, on the host clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = self.mark = 0.0

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm_up(self) -> None:
        """Start and stop the profiler once (in set-up): its first start
        initialises the tracing library, which takes seconds."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            sync(self.device)

    def start(self) -> None:
        from torch.profiler import record_function

        sync(self.device)
        self.prof = self._profile()
        self.prof.__enter__()
        self.mark = time.perf_counter()
        with record_function(MARK):
            pass
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """End the trace; inside a window only the collection stops."""
        sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, spans: Spans, default: str) -> dict:
        """Read the trace (once the window has closed)."""
        events = [_event(e) for e in self.prof.profiler.kineto_results.events()]
        return reduce_trace(events, self.mark, self.t0, self.t1, spans,
                            default)


class Parts:
    """The parts of a traced run's window, in turn: ``plain`` (nothing
    added: the whole-step metrics), ``profile`` (``torch.profiler``: the
    device metrics) and ``spans`` (timed spans between synchronisations:
    the layers' host and device times), of ``plain_seconds`` and
    ``trace_seconds`` and the rest.  An untraced run's window is one plain
    part.  At each change of part the drivers' counts are kept under the
    part's name (``plain_end``, ``plain_evals``, ``profile_points0``, ...)."""

    def __init__(self, run: Run):
        self.run = run
        self.trace = DeviceTrace(run.device) if run.trace else None
        if self.trace is not None:
            self.trace.warm_up()
        self.part = "plain"
        self.t0 = 0.0

    def begin(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    def tick(self, now: float, counts: Dict[str, float]) -> str:
        """The part the window is in at ``now``, moving to the next part
        when this one's time has passed."""
        traffic, counts_of = self.run.traffic, self.run.counts
        if self.trace is None:
            return self.part
        if (self.part == "plain"
                and now - self.t0 >= traffic["plain_seconds"]):
            counts_of.update({f"plain_{k}": v for k, v in counts.items()},
                             plain_end=now)
            counts_of.update({f"profile_{k}0": v for k, v in counts.items()})
            self.trace.start()
            self.part = "profile"
        elif (self.part == "profile"
              and now - self.trace.t0 >= traffic["trace_seconds"]):
            self.trace.stop()
            counts_of.update({f"profile_{k}1": v for k, v in counts.items()})
            counts_of.update({f"spans_{k}0": v for k, v in counts.items()},
                             spans_start=time.perf_counter())
            self.part = "spans"
        return self.part

    def end(self, counts: Dict[str, float], default: str) -> None:
        """Close the window: stop a trace still running and read it."""
        if self.trace is None:
            return
        if self.part == "profile":
            self.trace.stop()
            self.run.counts.update({f"profile_{k}1": v
                                    for k, v in counts.items()})
        if self.part != "plain":
            self.run.device_trace = self.trace.reduce(self.run.spans, default)


def _event(e) -> Tuple[str, bool, float, float, int]:
    """(name, on the device, start s, end s, device index) of a raw
    profiler event."""
    if hasattr(e, "start_ns"):
        start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
    else:
        start = e.start_us() * 1e-6
        end = start + e.duration_us() * 1e-6
    on_device = e.device_type() == torch.autograd.DeviceType.CUDA
    return e.name(), on_device, start, end, e.device_index()


def reduce_trace(events, mark_host: float, t0: float, t1: float,
                 spans: Spans, default: str) -> dict:
    """Busy seconds (the union of device operations' intervals, averaged
    over the cards), device seconds and count by kernel name, and the
    longest idle gaps named by the host span open when each began."""
    marks = [start for name, on_dev, start, _, _ in events
             if name == MARK and not on_dev]
    if not marks:
        raise RuntimeError("the profiler recorded no marker")
    offset = marks[0] - mark_host
    by_card: Dict[int, List[Tuple[float, float]]] = collections.defaultdict(list)
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for name, on_device, s, e, card in events:
        if not on_device:
            continue
        s, e = max(s - offset, t0), min(e - offset, t1)
        if e <= s:
            continue
        by_card[card].append((s, e))
        kernels[name][0] += 1
        kernels[name][1] += e - s
    busy, gaps = [], []
    for intervals in by_card.values():
        intervals.sort()
        total, cur_s, cur_e = 0.0, t0, t0
        for s, e in intervals:
            if s > cur_e:
                total += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
                cur_s = s
            cur_e = max(cur_e, e)
        total += cur_e - cur_s
        if t1 > cur_e:
            gaps.append((t1 - cur_e, cur_e))
        busy.append(total)
    gaps.sort(reverse=True)
    return {
        "window_s": t1 - t0,
        "busy_s": sum(busy) / len(busy) if busy else 0.0,
        "cards": len(by_card),
        "kernels": {k: (int(v[0]), v[1]) for k, v in kernels.items()},
        "idle_gaps": [[spans.name_at(at, default), length]
                      for length, at in gaps[:TOP]],
    }


def kernel_seconds(trace: dict, pattern: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``pattern`` as a whole word (``mlp_jet_kernel`` is not
    ``mlp_jet_bwd_kernel``)."""
    import re

    rx = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(pattern)
                    + r"(?![A-Za-z0-9_])")
    n, sec = 0, 0.0
    for name, (count, seconds) in trace["kernels"].items():
        if rx.search(name):
            n += count
            sec += seconds
    return n, sec


def device_ops(trace: dict) -> List[list]:
    rows = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][1])
    return [[name[:160], seconds] for name, (_, seconds) in rows[:TOP]]


# -- identity, the forbidden modules, the result --------------------------------

def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].rsplit(",", 1)[-1].strip() if lines else None


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole: ``pinn_elastodynamics_torch`` is not ``pinn_elastodynamics_tpu``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_block(run: Run) -> dict:
    kind = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "cpu")
    out = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": kind, "count": run.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.device.type == "cuda":
        out["power_limit"] = power_limit()
    if run.device_trace is not None:
        out["busy_s"] = run.device_trace["busy_s"]
        out["window_s"] = run.device_trace["window_s"]
    return out


def result_line(run: Run, metrics: Dict[str, Tuple[float, str]]) -> str:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, the ``breakdown`` of a traced run, and the
    compared numbers beside their limits last."""
    out = {
        "correct": run.correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": device_block(run),
    }
    if run.device_trace is not None:
        out["breakdown"] = {"device_ops": device_ops(run.device_trace),
                            "idle_gaps": run.device_trace["idle_gaps"]}
    # a gap that could not be read (no answer, a non-finite one) reads "inf"
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": lim} for k, (v, lim) in run.checks.items()}
    return json.dumps(out)


def print_checks(run: Run) -> None:
    for name, (value, limit) in run.checks.items():
        verdict = "ok" if value <= limit else "FAILED"
        print(f"check {name} {value!r} limit {limit!r} {verdict}",
              file=sys.stderr, flush=True)
