"""Line-search trials (each one value+grad) per L-BFGS iteration: the
program's ``lbfgs.trial`` spans over its ``lbfgs.iteration`` spans, in the
traced run's profiled part."""

from benchmark.program_spans import profiled


def read(run):
    spans = profiled(run)
    if spans is None or not spans.get("lbfgs.iteration"):
        return None
    return len(spans.get("lbfgs.trial", ())) / len(spans["lbfgs.iteration"])
