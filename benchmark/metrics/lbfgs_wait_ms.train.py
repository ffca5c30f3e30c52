"""Milliseconds per L-BFGS iteration in the program's ``lbfgs.read`` spans:
the host blocked on the device, reading the line search's flags, the stop
flag and the loss history, in the traced run's profiled part."""

from benchmark.program_spans import duration_s, per_iteration_ms


def read(run):
    return per_iteration_ms(run, lambda s: duration_s(s.get("lbfgs.read", ())))
