"""Set-up seconds: from process start to the first timed operation
(loading, building or loading the kernels, the banks, the weights, the
warm-up)."""


def read(run):
    return run.setup_s
