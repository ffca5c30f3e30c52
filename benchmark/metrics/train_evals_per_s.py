"""Real collocation rows times the loss value+grads completed in the
window, over the window's seconds."""


def read(run):
    if not run.window_s or "evals" not in run.counts:
        return None
    return run.counts["evals"] * run.counts["rows"] / run.window_s
