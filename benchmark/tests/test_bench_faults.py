"""A run with its timed path broken underneath reports ``correct``
false, once for each fault the cell can have: a step that returns its
state unchanged (from the first step, or in the window only), half of the
batch left out (the means taken over the rest), an answer altered where it
is made.  The run goes through
everything but the look for a card: set-up, the window, the reference,
the metrics and the result line."""

import json

import pytest

from benchmark import run as bench_run
from benchmark.core import result_line

from benchmark.tests.cells import small_run

FAULTS = [("plate_netbc.lbfgs", "frozen_step"),
          ("plate_netbc.lbfgs", "frozen_window"),
          ("plate_netbc.lbfgs", "half_batch"),
          ("wave_confined.lbfgs", "frozen_step"),
          ("wave_confined.lbfgs", "frozen_window"),
          ("wave_confined.lbfgs", "half_batch"),
          ("plate_netbc.serve", "half_batch"),
          ("plate_netbc.serve", "altered_answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_reads_not_correct(bench, cell, fault):
    run = small_run(bench, cell)
    metrics = bench_run.execute(run, bench, fault=fault)
    line = json.loads(result_line(run, metrics))
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", ["plate_netbc.lbfgs", "wave_confined.lbfgs",
                                  "plate_netbc.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_prints_the_contracts_line(bench, cell, trace):
    # a traced run profiles 0.2 s, then times spans for the rest
    run = small_run(bench, cell, trace=trace, seconds=3.0 if trace else 1.5)
    metrics = bench_run.execute(run, bench)
    line = json.loads(result_line(run, metrics))
    assert line["correct"] is True, line["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {n for n, _ in bench_run.metric_names(bench, cell, trace)}
    # the CPU has no device trace: only the trace's metrics are missing
    missing = names - set(line["metrics"])
    assert all("roofline" in n or "idle" in n or "launches" in n
               for n in missing), missing
    if trace:
        assert "breakdown" in line


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "plate_netbc.lbfgs", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
