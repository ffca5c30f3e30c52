"""Milliseconds of one value+grad: each loss evaluation, from its call to
the end of its backward, timed between synchronisations of the device,
over the traced run's spans part."""


def read(run):
    start = run.counts.get("spans_start")
    if start is None:
        return None
    spans = [t1 - t0 for t0, t1 in run.spans.by_name.get("loss_eval", ())
             if t0 >= start]
    return 1e3 * sum(spans) / len(spans) if spans else None
