"""Milliseconds per L-BFGS iteration of the optimizer's own host work:
the time inside the program's ``lbfgs.minimize`` spans covered by no
``vg`` (value+grad) or ``lbfgs.read`` (host read of a device value) span,
over the ``lbfgs.iteration`` spans, in the traced run's profiled part."""

from benchmark.program_spans import per_iteration_ms, uncovered_s


def read(run):
    return per_iteration_ms(run, lambda s: sum(uncovered_s(
        s.get("lbfgs.minimize", ()),
        s.get("vg", []) + s.get("lbfgs.read", []))))
