"""Case abstraction: model + material + banks + loss spec + phases.

Counterpart of ``pinn_elastodynamics_tpu/cases/base.py``: :class:`Phase`,
:class:`Case` and the phase loss with a frozen remainder
(:func:`_phase_loss_fn`).  ``run_pipeline`` (the L-BFGS phases and the
Adam warm-up it configures) and the FEM frame fields are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..banks import PointBank
from ..losses.terms import LossSpec
from ..ops.elasticity import Material
from ..utils.treepath import path_get, path_set


@dataclasses.dataclass(frozen=True)
class Phase:
    """One optimization phase of a case's pipeline.

    ``trainable``: None = all params; else the dotted path of the subtree
    to train ('uv' | 'dist' | 'part' | 'uv.mlp') while the rest stays
    frozen (the reference's var_list, train.py:220-250).  ``scale``
    multiplies the phase loss (the reference's 1000x for dist/part).
    """

    name: str
    loss: LossSpec
    trainable: Optional[str] = None
    scale: float = 1.0
    maxiter: int = 1000
    ftol: float = 0.0


@dataclasses.dataclass
class Case:
    name: str
    model: object
    material: Material
    plane: str
    loss: LossSpec                      # main loss
    banks: Dict[str, PointBank]
    phases: Tuple[Phase, ...]           # full pipeline incl. main phase
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]
    device: object = "cuda"             # where the banks and params live

    def init_params(self, seed: int = 1111, dtype=torch.float32):
        """Fresh parameters on the case's device, drawn from a
        ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        return self.model.init(gen, dtype, self.device)

    def loss_fn(self, spec: LossSpec, scale: float = 1.0) -> Callable:
        """Scalar loss over the full parameter tree."""

        def fn(params):
            total, _ = spec.evaluate(self.model, params, self.material,
                                     self.banks)
            return scale * total

        return fn

    def loss_and_aux_fn(self, spec: Optional[LossSpec] = None) -> Callable:
        spec = spec or self.loss

        def fn(params):
            return spec.evaluate(self.model, params, self.material, self.banks)

        return fn

    def components(self, params) -> Dict[str, float]:
        """The reference's ``getloss`` (train.py:588-612): every component."""
        with torch.no_grad():
            _, comps = self.loss.evaluate(self.model, params, self.material,
                                          self.banks)
        return {k: float(v) for k, v in comps.items()}


def _phase_loss_fn(case: Case, phase: Phase, params):
    """A loss over the phase's trainable subtree with the rest frozen.

    Returns (sub_fn, sub0, merge): ``sub_fn(sub)`` is the phase loss with
    ``sub`` at ``phase.trainable``, ``sub0`` the current subtree and
    ``merge(p, sub)`` puts a trained subtree back.
    """
    full_fn = case.loss_fn(phase.loss, phase.scale)
    if phase.trainable is None:
        return full_fn, params, lambda p, sub: sub

    key = phase.trainable

    def sub_fn(sub):
        return full_fn(path_set(params, key, sub))

    def merge(p, sub):
        return path_set(p, key, sub)

    return sub_fn, path_get(params, key), merge
