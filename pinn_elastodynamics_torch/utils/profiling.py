"""Profiling utilities: a step timer, the program's spans, profiler traces.

Counterpart of ``pinn_elastodynamics_tpu/utils/profiling.py``.  Fills the
reference's tracing gap (SURVEY.md §5: wall-clock prints only): device-step
timing, host spans at the program's layer boundaries (the optimizer, the
value+grad, serving), and an optional ``torch.profiler`` trace in place of
the JAX package's ``xla_trace``.  Where JAX calls ``block_until_ready`` on a
result, the timer synchronises the CUDA device that holds it.

Spans are recorded only while a ``torch.profiler`` session records, so
they describe the same seconds as its device trace; otherwise ``span``
returns one shared object that does nothing.  Times are
``time.perf_counter()`` seconds, the host clock onto which a reader maps
the profiler's events through a marker range of known host time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .tree import tree_leaves

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
# float32 outside the tensor cores, which the exact-f32 FFMA kernels run on,
# and the HBM3 rate.  The denominators of every bound and utilisation the
# port reports.
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _block(out) -> None:
    """Wait for the CUDA work behind ``out`` (a tensor or a tree of them);
    a result on the CPU is ready when it is returned."""
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def time_blocked(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean seconds per call, waiting for the device after every call
    (includes dispatch latency — what a host-driven loop like the
    reference's scipy L-BFGS pays every iteration)."""
    for _ in range(warmup):
        _block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _block(fn(*args))
    return (time.perf_counter() - t0) / iters


# -- spans --------------------------------------------------------------------

SPAN_CAPACITY = 1 << 17   # records kept; the oldest go first
SPAN_MARK = "pinn_elastodynamics_torch.spans.mark"


class SpanRecord(NamedTuple):
    """One closed span: host-clock seconds, its id, the id of the span open
    around it on its thread (0: none), the id of the outermost such span
    (its own id at the top: a request's id under ``serve.evaluate``), the
    thread, and the counts given when it was opened."""
    name: str
    start: float
    end: float
    id: int
    parent: int
    root: int
    thread: int
    counts: dict


class _Recorder:
    """The spans of this process: a bounded buffer, ids, one stack of open
    spans per thread."""

    def __init__(self, capacity: int):
        self.records = collections.deque(maxlen=capacity)
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder(SPAN_CAPACITY)


class _NoSpan:
    """What ``span`` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "root", "stack", "start")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        self.stack = _RECORDER.stack()
        outer = self.stack[-1] if self.stack else None
        self.id = next(_RECORDER.ids)
        self.parent = outer.id if outer is not None else 0
        self.root = outer.root if outer is not None else self.id
        self.stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        self.stack.pop()
        _RECORDER.records.append(SpanRecord(
            self.name, self.start, end, self.id, self.parent, self.root,
            threading.get_ident(), self.counts))
        return False


def span(name: str, **counts):
    """A context manager that records ``name`` over its block, with
    ``counts`` (numbers known when it opens), while a ``torch.profiler``
    session records; else the shared no-op ``NO_SPAN``.  Read the records
    with ``spans()``.  Nothing is sent to the profiler: a range there that
    encloses kernels would show on the device's lane."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, counts)


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (at most ``SPAN_CAPACITY``)."""
    return list(_RECORDER.records)


def _chrome_events(records, offset_us: float, pid) -> list:
    """Chrome-trace complete ("X") events of ``records``, their host times
    moved by ``offset_us`` onto the profiler file's clock."""
    return [{"ph": "X", "cat": "program_span", "name": r.name,
             "pid": pid, "tid": r.thread,
             "ts": r.start * 1e6 + offset_us,
             "dur": (r.end - r.start) * 1e6,
             "args": {"id": r.id, "parent": r.parent, "root": r.root,
                      **r.counts}}
            for r in records]


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace (host ops, and the CUDA kernels
    when a GPU is present) into ``log_dir`` in the TensorBoard profiler's
    format, when ``log_dir`` is set, and the program's spans of the same
    seconds beside it (``<name>.spans.json``, Chrome-trace events on the
    profiler file's clock: the two share one time axis)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    stem = os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}")

    def export(prof):
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(f"{stem}.pt.trace.json")

    with profile(activities=activities, on_trace_ready=export):
        opened = time.perf_counter()
        # A process's first range can be stamped hundreds of microseconds
        # late; the end of the second, read on both clocks, places the spans.
        for _ in range(2):
            with record_function(SPAN_MARK):
                pass
            mark = time.perf_counter()
        yield
    # the profiler's file is written when the session ends
    with open(f"{stem}.pt.trace.json") as f:
        trace = json.load(f)
    last = max((e for e in trace["traceEvents"]
                if e.get("name") == SPAN_MARK), key=lambda e: e["ts"])
    records = [r for r in spans() if r.start >= opened]
    out = {"traceEvents": _chrome_events(
               records, last["ts"] + last["dur"] - mark * 1e6, os.getpid()),
           "displayTimeUnit": "ms"}
    if "baseTimeNanoseconds" in trace:
        out["baseTimeNanoseconds"] = trace["baseTimeNanoseconds"]
    with open(f"{stem}.spans.json", "w") as f:
        json.dump(out, f)


def flops_per_point(dims, n_streams: int) -> int:
    """FLOPs per point of one MLP jet forward: 2 per weight per stream."""
    return 2 * n_streams * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def bwd_flops_per_point(dims, n_streams: int) -> int:
    """FLOPs per point that the backward of one MLP jet needs: per hidden
    layer the forward once (2S per weight), the weight gradient and the
    input cotangent (2S each); the head's weight gradient and input
    cotangent.  The kernel's recompute of the non-value pre-activations in
    the reverse sweep saves memory, not work the function needs, so it is
    not counted."""
    s = n_streams
    widths = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return 6 * s * sum(widths[:-1]) + 4 * s * widths[-1]
