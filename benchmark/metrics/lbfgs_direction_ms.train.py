"""Milliseconds per L-BFGS iteration in the program's ``lbfgs.direction``
spans (the newest pair's store and the two-loop), in the traced run's
profiled part."""

from benchmark.program_spans import duration_s, per_iteration_ms


def read(run):
    return per_iteration_ms(
        run, lambda s: duration_s(s.get("lbfgs.direction", ())))
