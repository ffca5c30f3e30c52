"""``ls_trials_per_iter.train`` of the W1 cell, ``wave_confined.lbfgs``, which moves that
cell's own rate, ``train_evals_per_s.wave_confined``.  The reader is
``ls_trials_per_iter.train``'s."""

from benchmark.core import metric_reader

read = metric_reader("ls_trials_per_iter.train")
