"""``mfu.train`` of the four-card cell, ``wave_confined_m1.lbfgs_4chip``:
the operations of one global value+grad (every rank's rows) times the
value+grads of the plain part, over its seconds and the peak of the four
cards.  The reader is ``mfu.train``'s, which divides by ``run.chips``."""

from benchmark.core import metric_reader

read = metric_reader("mfu.train")
