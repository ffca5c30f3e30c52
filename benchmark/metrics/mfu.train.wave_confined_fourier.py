"""``mfu.train`` of the W2 cell, ``wave_confined_fourier.lbfgs``, which moves
``train_evals_per_s``.  The reader is ``mfu.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("mfu.train")
