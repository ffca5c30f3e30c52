"""``device_idle.train`` of the E1 cell, ``elastic3d.lbfgs``, which moves
``train_evals_per_s``.  The reader is ``device_idle.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("device_idle.train")
