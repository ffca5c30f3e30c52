"""The control of each cell comes out not correct: the reference, put in
the program's place and computed in TF32 (the nearest precision below the
configuration's float32), fails at least one compared number, where the
program passes every one.  On the CPU at a small size; on the card at the
cell's own size by ``python3 -m benchmark.study``."""

import pytest

from benchmark import run as bench_run

from benchmark.tests.cells import small_run

CELLS = ("plate_netbc.lbfgs", "wave_confined.lbfgs", "plate_netbc.serve")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 7])
def test_program_is_correct_and_control_is_not(bench, cell, seed):
    run = small_run(bench, cell, seed=seed)
    bench_run.execute(run, bench)
    assert run.correct, run.checks
    control = small_run(bench, cell, seed=seed)
    bench_run.execute(control, bench, control=True)
    assert not control.correct, control.checks
