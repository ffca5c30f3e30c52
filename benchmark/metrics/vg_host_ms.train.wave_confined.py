"""``vg_host_ms.train`` of the W1 cell, ``wave_confined.lbfgs``, which moves that
cell's own rate, ``train_evals_per_s.wave_confined``.  The reader is
``vg_host_ms.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("vg_host_ms.train")
