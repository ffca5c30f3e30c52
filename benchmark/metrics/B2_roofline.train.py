"""The MLP backward (B2, ``mlp_jet_bwd_kernel`` and the sum
of its per-block partials, ``reduce_partials``) against its bound: the
operations the loss needs of that stage per launch (counted from shapes
over real rows: the net's backward), times its launches in the
trace, over the float32 peak, over their device time, in percent."""

from benchmark.core import kernel_seconds
from benchmark.flops import roofline


def read(run):
    t = run.device_trace
    if t is None:
        return None
    n, seconds = kernel_seconds(t, "mlp_jet_bwd_kernel")
    if not n:
        return None
    seconds += kernel_seconds(t, "reduce_partials")[1]
    return 100.0 * roofline(run.flops["bwd"] * n, run.flops["bwd_bytes"] * n,
                            seconds)
