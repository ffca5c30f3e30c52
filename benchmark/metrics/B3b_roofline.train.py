"""The seeded MLP backward (B3b: ``mlp_jet_bwd_kernel`` with the whole seed
cotangent, and the sum of its per-block partials, ``reduce_partials``)
against its bound: the operations the loss needs of that stage per launch
(counted from shapes over real rows: the MLP's backward over the four
streams, without the seed cotangent that a frozen embedding does not need),
times its launches in the trace, over the float32 peak, over their device
time, in percent.  The kernel names are B2's, so the reader is
``B2_roofline.train``'s; the cell runs no B2."""

from benchmark.core import metric_reader

read = metric_reader("B2_roofline.train")
