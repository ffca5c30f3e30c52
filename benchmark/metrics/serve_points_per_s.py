"""Points answered in the window over the window's seconds."""


def read(run):
    if not run.window_s or "points" not in run.counts:
        return None
    return run.counts["points"] / run.window_s
