"""``B2_roofline.train`` of the E1 cell, ``elastic3d.lbfgs``, which moves
``train_evals_per_s``: B2 (``mlp_jet_bwd_kernel`` on the wide-tile body at
five streams, and ``reduce_partials``) against the operations and bytes
the adapter counts per launch.  The reader is ``B2_roofline.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("B2_roofline.train")
