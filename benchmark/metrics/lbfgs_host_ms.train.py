"""Milliseconds per L-BFGS iteration outside the value+grads: the
two-loop, the line search's scalar work and its reads of flags, over the
traced run's spans part."""


def read(run):
    start = run.counts.get("spans_start")
    iters = run.counts.get("iters", 0) - run.counts.get("spans_iters0", 0)
    if start is None or iters <= 0:
        return None
    inside = sum(t1 - t0 for t0, t1 in run.spans.by_name.get("loss_eval", ())
                 if t0 >= start)
    return 1e3 * (run.counts["window_end"] - start - inside) / iters
