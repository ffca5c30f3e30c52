"""``mfu.train`` of the E1 cell, ``elastic3d.lbfgs``, which moves
``train_evals_per_s``.  The reader is ``mfu.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("mfu.train")
