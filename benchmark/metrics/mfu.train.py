"""The whole training step's share of the cards' float32 peak: the
operations one value+grad of the loss needs (counted from shapes, real
rows, the backward of trainable nets only) times the value+grads of the
traced run's plain part (nothing added), over that part's seconds and the
peak of every card used, in percent."""

from benchmark.flops import F32_PEAK_FLOPS


def read(run):
    c = run.counts
    if not c.get("plain_evals"):
        return None
    rate = run.flops["step"] * c["plain_evals"] / (c["plain_end"]
                                                  - c["window_start"])
    return 100.0 * rate / (F32_PEAK_FLOPS * run.chips)
