"""Plain reference of the million-point confined wave (M1): W1's loss over
the whole, unsharded banks.

M1 is W1 (``wave_confined.py``: one 3-140x6-7 tanh MLP, soft BCs, plane
strain, E = 2.5, ν = 0.25) on the banks of BASELINE config #3, the sampler
at scale 6.0.  The program splits every bank over its ranks and sums each
mean's partial sums and counts over them, and then the gradients; the
loss and its gradient are the same functions of the parameters, so
sharding changes only the order of summation.  The reference therefore
keeps one process and the whole banks, and sums row blocks in turn
(W1's ``loss_blocks``), in blocks four times W1's: the banks are 13 times
W1's rows.
"""

from __future__ import annotations

import torch

from . import wave_confined

BLOCK = 131072


def loss_blocks(nets: dict, banks: dict, precision: str, device,
                block: int = BLOCK):
    """The loss as a sum of per-block scalars (W1's)."""
    return wave_confined.loss_blocks(nets, banks, precision, device, block)


def loss(nets: dict, banks: dict, precision: str, device,
         block: int = BLOCK) -> torch.Tensor:
    """The whole loss, the sum of ``loss_blocks``."""
    return sum(loss_blocks(nets, banks, precision, device, block))
