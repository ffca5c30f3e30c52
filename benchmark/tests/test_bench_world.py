"""The four-card cell's driver (``drivers/train_world.py``) in a gloo world
of 4 on the CPU, at a small scale: the ranks run in lockstep and stop on
the same segment, their parameters stay equal, the check passes, and it
fails when each rank optimises its own shard alone.  The cell's readers on
a made-up traced run, and on one that has nothing for them to read."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark import core
from benchmark import run as bench_run
from benchmark.core import Run, metric_reader, result_line
from benchmark.run import ROOT

from benchmark.tests.cells import small_run

CELL = "wave_confined_m1.lbfgs_4chip"
READERS = ("nccl_ms_per_vg.train4", "allreduce_bytes_per_vg.train4",
           "rank_skew_ms.train4", "mfu.train4")


def _world_run(bench, **kw) -> Run:
    run = small_run(bench, CELL, **kw)
    run.chips = 4
    return run


@pytest.fixture(scope="module")
def bench_m():
    return bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")


@pytest.fixture(scope="module")
def sound(bench_m):
    run = _world_run(bench_m, trace=True, seconds=1.5)
    metrics = bench_run.execute(run, bench_m)
    return run, metrics


def test_sound_run_is_correct(sound):
    run, metrics = sound
    line = json.loads(result_line(run, metrics))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["ranks_param_gap"]["value"] == 0.0
    assert line["checks"]["window_updates_lost"]["value"] == 0.0
    assert line["attempted"] > 0 and line["failed"] == 0


def test_ranks_stop_on_the_same_segment(sound):
    run, _ = sound
    iters = [run.counts[f"iters.rank{r}"] for r in range(4)]
    assert iters == [run.counts["iters"]] * 4
    assert run.window_s >= run.seconds


def test_traced_world_reports_the_host_metrics(sound):
    run, metrics = sound
    # the CPU has no device trace: NCCL's time is the one missing
    assert set(metrics) == set(READERS) - {"nccl_ms_per_vg.train4"}
    assert all(math.isfinite(v) for v, _ in metrics.values())
    # the packed gradient (100,247 float32) and the packed sums
    n_params = 100247
    assert 4 * n_params < metrics["allreduce_bytes_per_vg.train4"][0] < \
        4 * (n_params + 64)


def test_dropped_allreduce_reads_not_correct(bench_m):
    run = _world_run(bench_m)
    readings = bench_run.execute(run, bench_m, fault="dropped_allreduce")
    assert not run.correct
    assert run.checks["ranks_param_gap"][0] > 0.0
    assert run.checks["loss_gap"][0] > run.checks["loss_gap"][1]
    assert readings


def _fake_traced_run() -> Run:
    run = Run(cell={"name": CELL}, config={}, traffic={}, seed=1,
              seconds=1.0, trace=True, device=torch.device("cpu"), chips=4,
              t_start=time.perf_counter(), limits={})
    run.flops = {"step": 4.0e12}
    run.counts.update(window_start=100.0, plain_end=110.0, plain_evals=200,
                      profile_evals0=200, profile_evals1=260,
                      profile_allreduce_bytes0=200 * 401108,
                      profile_allreduce_bytes1=260 * 401108)
    run.device_trace = {"window_s": 3.0, "busy_s": 2.0, "cards": 1,
                        "idle_gaps": [], "kernels": {
                            "ncclDevKernel_AllReduce_Sum_f32_RING_LL": (
                                120, 0.06),
                            # the profiler's range over the same kernels
                            "nccl:all_reduce": (120, 0.06),
                            "mlp_jet_bwd_kernel<4, false, 16, 2>": (60, 1.2)}}
    for r in range(4):
        for k in range(3):
            start = 105.0 + k + 1e-3 * r * (k + 1)
            run.spans.add(f"mesh.all_reduce.grads.rank{r}", start,
                          start + 1e-4)
    return run


def test_readers_on_a_made_up_traced_run():
    run = _fake_traced_run()
    read = {name: metric_reader(name)(run) for name in READERS}
    assert read["nccl_ms_per_vg.train4"] == pytest.approx(1.0)
    assert read["allreduce_bytes_per_vg.train4"] == 401108
    # per value+grad: 3, 6 and 9 ms between the first rank and the last
    assert read["rank_skew_ms.train4"] == pytest.approx(6.0)
    assert read["mfu.train4"] == pytest.approx(
        100.0 * 4.0e12 * 200 / 10.0 / (67e12 * 4))


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_an_untraced_run(name):
    run = Run(cell={"name": CELL}, config={}, traffic={}, seed=1,
              seconds=1.0, trace=False, device=torch.device("cpu"), chips=4,
              t_start=time.perf_counter(), limits={})
    run.flops = {"step": 1.0}
    assert metric_reader(name)(run) is None


def test_a_program_without_the_mesh_spans_reads_no_skew():
    run = _fake_traced_run()
    run.spans.by_name.clear()
    assert metric_reader("rank_skew_ms.train4")(run) is None
    del run.counts["profile_allreduce_bytes1"]
    assert metric_reader("allreduce_bytes_per_vg.train4")(run) is None


def _loaded(modules) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_no_jax_and_the_reference_loads_nothing_of_the_program():
    assert not _loaded(["benchmark.drivers.train_world",
                        "benchmark.adapters.wave_confined_m1"]) & set(
        core.FORBIDDEN)
    loaded = _loaded(["benchmark.reference.wave_confined_m1"])
    assert not loaded & ({"pinn_elastodynamics_torch"} | set(core.FORBIDDEN))
