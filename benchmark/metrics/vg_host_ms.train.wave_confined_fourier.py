"""``vg_host_ms.train`` of the W2 cell, ``wave_confined_fourier.lbfgs``, which moves
``train_evals_per_s``.  The reader is ``vg_host_ms.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("vg_host_ms.train")
