"""Bytes the program's all-reduces hand over on rank 0 per value+grad
(its ``parallel/mesh.py::COLLECTIVE_BYTES``, kinds ``sums`` and
``grads``), over the traced run's profiled part: the packed gradient (4
bytes a parameter) and the loss's packed sums and counts."""


def read(run):
    c = run.counts
    evals = c.get("profile_evals1", 0) - c.get("profile_evals0", 0)
    if "profile_allreduce_bytes1" not in c or evals <= 0:
        return None
    return (c["profile_allreduce_bytes1"] - c["profile_allreduce_bytes0"]) / evals
