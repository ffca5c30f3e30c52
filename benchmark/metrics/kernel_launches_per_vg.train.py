"""Launches of the program's jet kernels (its forward and backward
counters, kernels/fused_jet.py and fused_jet_vjp.py) per value+grad over
the window."""


def read(run):
    if not run.counts.get("launches") or not run.counts.get("evals"):
        return None
    return run.counts["launches"] / run.counts["evals"]
