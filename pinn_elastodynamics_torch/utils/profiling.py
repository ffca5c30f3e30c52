"""Profiling utilities: step timers, step-rate counters, profiler traces.

Counterpart of ``pinn_elastodynamics_tpu/utils/profiling.py``.  Fills the
reference's tracing gap (SURVEY.md §5: wall-clock prints only): device-step
timing (block-per-call and chained/amortized — the latter is what a
device-resident optimizer loop achieves), collocation-evals/sec, and an
optional ``torch.profiler`` trace in place of the JAX package's
``xla_trace``.  Where JAX calls ``block_until_ready`` on a result, these
timers synchronise the CUDA device that holds it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from .tree import tree_leaves


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


def time_chained(
    step_fn: Callable, carry, *args, iters: int = 100, warmup: int = 2
) -> float:
    """Mean seconds per step of a self-feeding step function
    ``carry -> carry`` — amortized device throughput, the number a
    device-resident optimizer loop achieves."""
    for _ in range(warmup):
        carry = step_fn(carry, *args)
    _block(carry)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step_fn(carry, *args)
    _block(carry)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace (host ops, and the CUDA kernels
    when a GPU is present) into ``log_dir`` in the TensorBoard profiler's
    format, when ``log_dir`` is set."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def evals_per_sec(n_points: int, step_seconds: float) -> float:
    return n_points / step_seconds


def flops_estimate_mlp_jet(
    n_points: int, layers, *, order: int = 1, with_grad: bool = True
) -> int:
    """Rough FLOP count for a jet forward (+ backward) through a tanh MLP:
    (order-dependent) derivative streams share each layer matmul."""
    streams = 1 + (layers[0])  # value + A tangents
    if order >= 2:
        streams += 1
    fwd = 0
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        fwd += 2 * fan_in * fan_out * streams
    total = fwd * (3 if with_grad else 1)  # backward ≈ 2x forward
    return n_points * total
