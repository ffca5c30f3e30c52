"""How far apart the ranks reach the gradient's all-reduce: for each
value+grad of the traced run's profiled part, the latest rank's start of
its ``mesh.all_reduce`` span of kind ``grads`` less the earliest rank's,
on the host clock the ranks share; the median, in ms.  The driver keeps
each rank's spans under ``mesh.all_reduce.grads.rank<r>``; the ranks
change parts on the same segment, so the k-th span of each rank belongs
to the same value+grad."""

import statistics


def read(run):
    starts = [[t0 for t0, _ in run.spans.by_name.get(
        f"mesh.all_reduce.grads.rank{r}", ())] for r in range(run.chips)]
    n = len(starts[0])
    if run.chips < 2 or n == 0 or any(len(s) != n for s in starts):
        return None
    return 1e3 * statistics.median(
        max(s[k] for s in starts) - min(s[k] for s in starts)
        for k in range(n))
