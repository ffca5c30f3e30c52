"""Rank 0's device milliseconds in NCCL kernels per value+grad, over the
traced run's profiled part.  In the four-card cell the only NCCL kernels
are those the program's ``mesh.all_reduce`` spans launch (the loss's sums
in the forward, the gradient in the backward): the driver's own messages
go over a gloo group in host memory.  Kernels are named ``ncclDevKernel_*``
(``ncclKernel_*`` before NCCL 2.19); the profiler's ``nccl:all_reduce``
range on the device's lane spans the same interval and is not counted.
An all-reduce's kernel runs until the slowest rank has joined it, so this
time holds the wait for that rank."""

NCCL_KERNELS = ("ncclDevKernel", "ncclKernel")


def read(run):
    t, c = run.device_trace, run.counts
    evals = c.get("profile_evals1", 0) - c.get("profile_evals0", 0)
    if t is None or evals <= 0:
        return None
    seconds = sum(s for name, (_, s) in t["kernels"].items()
                  if name.startswith(NCCL_KERNELS))
    return 1e3 * seconds / evals if seconds else None
