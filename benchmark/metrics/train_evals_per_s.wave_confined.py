"""``train_evals_per_s`` of the W1 cell, ``wave_confined.lbfgs``, under a
name of its own so that it carries its own bound.  The reader is
``train_evals_per_s``'s."""

from benchmark.core import metric_reader

read = metric_reader("train_evals_per_s")
