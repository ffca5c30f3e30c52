"""The million-point confined wave (M1): W1 on the banks of BASELINE
config #3, split over the ranks of a world.

The banks are W1's (``wave_confined.py``), drawn by the benchmark's frozen
samplers at the configuration's scale; every rank draws the same banks
from the seed.  ``program`` gives one rank's loss: the whole banks made
into the program's ``PointBank``s on the host, padded as the
configuration says, and this rank's contiguous shard of each put on its
card by the program's ``parallel.mesh.shard_banks``; the weights
broadcast from rank 0 by ``parallel.mesh.replicate``.  The program's loss
then sums every mean's sums and counts over the ranks, and the gradient.
"""

from __future__ import annotations

import dataclasses

from ..weights import program_tree
from .plate_netbc import program_banks
from .wave_confined import (TRAINABLE, banks, real_rows, reference_nets,
                            train_flops)

REFERENCE = "wave_confined_m1"

__all__ = ["REFERENCE", "TRAINABLE", "banks", "program", "real_rows",
           "reference_nets", "train_flops"]


def program(cfg: dict, banks: dict, weights: dict, mesh, fault=None):
    """(sub_fn, sub0): this rank's part of the program's one phase, over
    every parameter.  ``fault="half_batch"`` keeps every other row of each
    whole bank (``plate_netbc.program_banks``); ``"dropped_allreduce"``
    leaves each rank's shard unsharded, so that the rank optimises its own
    rows alone, with no collective."""
    from pinn_elastodynamics_torch.cases import wave_confined
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.parallel.mesh import replicate, shard_banks

    case = wave_confined.build(scale=1e-3, max_t=cfg["max_t"],
                               device=mesh.device)
    whole = program_banks(cfg, banks, "cpu",
                          fault if fault == "half_batch" else None)
    shards = shard_banks(whole, mesh)
    if fault == "dropped_allreduce":
        shards = {k: dataclasses.replace(b, mesh=None)
                  for k, b in shards.items()}
    case.banks = shards
    phase = case.phases[-1]
    if phase.trainable is not None:
        raise RuntimeError(f"W1's phase trains {phase.trainable!r}")
    params = replicate(program_tree(weights[TRAINABLE]), mesh)
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    return sub_fn, sub0
