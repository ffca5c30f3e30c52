"""Cells cut to a size the CPU runs in a second, for the tests."""

import time

import torch

from benchmark import run as bench_run
from benchmark.core import Run

SMALL_SCALE = 0.003


def small_run(bench: dict, cell: str, *, seed: int = 2**31 + 11,
              trace: bool = False, seconds: float = 1.5) -> Run:
    """A run of ``cell`` on the CPU at a small scale."""
    c, config, traffic, limits = bench_run.cell_files(bench, cell)
    config = dict(config, scale=SMALL_SCALE)
    traffic = dict(traffic, memory=4, warm_iters=6, segment=1, plain_seconds=0.2,
                   trace_seconds=0.2,
                   frame_points=400,
                   chunk=256, check_requests=6)
    return Run(cell=c, config=config, traffic=traffic, seed=seed,
               seconds=seconds, trace=trace, device=torch.device("cpu"),
               chips=1, t_start=time.perf_counter(), limits=limits)
