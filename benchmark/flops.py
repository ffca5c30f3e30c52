"""Operations counted from shapes, and the card's peaks.

Copies of the program's sound arithmetic (``utils/profiling.py``:
``flops_per_point``, ``bwd_flops_per_point``, the float32 peak and the HBM
rate), with what the benchmark adds: the work one value+grad of a loss
needs, over real rows only, with the backward of trainable nets and the
forward alone of frozen ones.  Only the products with the weights are
counted (two operations per multiply-add): tanh, the jets' elementwise
product rule, the residuals and the reductions are left out, so a share of
the peak reads low rather than high.
"""

from __future__ import annotations

from typing import Sequence

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates):
# float32 on the CUDA cores, which the exact-f32 kernels run on, and HBM3.
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def weights(dims: Sequence[int]) -> list:
    return [a * b for a, b in zip(dims[:-1], dims[1:])]


def fwd(dims: Sequence[int], streams: int) -> int:
    """One jet forward through a net, per point: 2 per weight per stream
    (``flops_per_point``)."""
    return 2 * streams * sum(weights(dims))


def bwd(dims: Sequence[int], streams: int) -> int:
    """What the backward of one net's jet needs per point when only its
    inputs were saved (``bwd_flops_per_point``): per hidden layer the
    forward again, the weight gradient and the input cotangent (6 per
    weight per stream); the head's weight gradient and input cotangent (4).
    A kernel's further recompute saves memory, not work, and is not
    counted."""
    w = weights(dims)
    return 6 * streams * sum(w[:-1]) + 4 * streams * w[-1]


def value_and_grad(dims: Sequence[int], streams: int) -> int:
    """One value+grad through a trainable net, per point: the forward
    (2 per weight per stream), the weight gradients (2) and the input
    cotangents (2), the first layer's input cotangent excepted (the inputs
    are coordinates)."""
    w = weights(dims)
    return 6 * streams * sum(w) - 2 * streams * w[0]


def roofline(flops: float, nbytes: float, seconds: float) -> float:
    """The share of the card's bound that a stage reached: the larger of
    its operations over the float32 peak and its bytes over the HBM rate,
    over the device time it took."""
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) / seconds
