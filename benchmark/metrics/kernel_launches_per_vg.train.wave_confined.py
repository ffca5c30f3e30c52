"""``kernel_launches_per_vg.train`` of the W1 cell, ``wave_confined.lbfgs``, which moves that
cell's own rate, ``train_evals_per_s.wave_confined``.  The reader is
``kernel_launches_per_vg.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("kernel_launches_per_vg.train")
