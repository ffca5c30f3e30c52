"""Case abstraction: model + material + banks + loss spec + phases.

Counterpart of ``pinn_elastodynamics_tpu/cases/base.py``: :class:`Phase`,
:class:`Case` with its FEM-comparison and Adam warm-up fields, the phase
loss with a frozen remainder (:func:`_phase_loss_fn`) and
:func:`run_pipeline`, which runs the case's phases (the net-BC plate's
dist → part → uv curriculum, train.py:958-968) with L-BFGS, an optional
Adam warm-up before the last phase, and checkpoints that resume an
interrupted phase, and the extended-precision phase loss
(:func:`mixed_precision_phase_fn`: float64 parameters and loss tail over
the float32 compute path).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..banks import PointBank
from ..losses.terms import LossSpec
from ..ops.elasticity import Material
from ..train import lbfgs as lbfgs_mod
from ..train.adam import run_adam
from ..train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    tensors_from_checkpoint,
)
from ..utils.tree import tree_map
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
    n_frames: int = 0                   # FEM comparison frames
    fem_dir: Optional[str] = None
    # FEM .mat files may store coordinates in a translated frame; add this
    # offset to FEM (x, y) to get PINN coordinates.
    fem_offset: Tuple[float, float] = (0.0, 0.0)
    eval_grid: Optional[np.ndarray] = None  # (N, ndim) spatial eval points
    adam_iters: int = 0                 # optional Adam warm-up before L-BFGS
    adam_lr: float = 1e-3
    device: object = "cuda"             # where the banks and params live

    @property
    def max_t(self) -> float:
        return float(self.ub[-1])

    def frame_time(self, frame: int) -> float:
        """Time of FEM frame i: t = i · T / (n_frames - 1) (train.py:993-994)."""
        return frame * self.max_t / (self.n_frames - 1)

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


def mixed_precision_phase_fn(case: Case, phase: Phase, params64):
    """Extended-precision phase loss: float64 parameter and optimizer space
    over the float32 compute path.

    Near the optimum the per-iteration loss decrease and the curvature
    pairs fall below f32 resolution (docs/STATUS_r2.md); the reference
    trains entirely in f64 on the CPU (train.py:115).  Here the jets stay
    f32 (the CUDA kernels on a CUDA tensor): the parameters are cast
    f64 -> f32 at the model boundary by a differentiable ``.to``, so the
    gradients come back float64, while the square-and-reduce tail
    (``LossSpec.accum_dtype``) and every L-BFGS internal run in float64.
    The case's banks must be float32, like the parameters the model sees.

    Returns (sub_fn, sub0, merge) like :func:`_phase_loss_fn`, over f64
    trees.
    """
    spec64 = dataclasses.replace(phase.loss, accum_dtype="float64")

    def to32(tree):
        return tree_map(lambda t: t.to(torch.float32), tree)

    if phase.trainable is None:
        def sub_fn(p64):
            total, _ = spec64.evaluate(case.model, to32(p64), case.material,
                                       case.banks)
            return phase.scale * total

        return sub_fn, params64, lambda p, sub: sub

    key = phase.trainable
    frozen32 = to32(params64)

    def sub_fn(sub64):
        total, _ = spec64.evaluate(
            case.model, path_set(frozen32, key, to32(sub64)),
            case.material, case.banks,
        )
        return phase.scale * total

    def merge(p, sub):
        return path_set(p, key, sub)

    return sub_fn, path_get(params64, key), merge


def run_pipeline(
    case: Case,
    params=None,
    *,
    seed: int = 1111,
    dtype=torch.float32,
    log_every: int = 0,
    maxiter_override: Optional[Dict[str, int]] = None,
    on_phase_end: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every_segments: int = 10,
    segment: int = 100,
    resume: bool = False,
):
    """Run every phase of the case's pipeline; returns (params, phase_results).

    With ``checkpoint_path`` set, parameters and the full L-BFGS carry
    (curvature memory, last value and gradient, iteration counters) are
    saved atomically every ``checkpoint_every_segments`` L-BFGS segments.
    With ``resume`` set and that checkpoint present, completed phases are
    skipped and the interrupted phase continues from its carry with the
    rest of its iteration budget.
    """
    resume_state = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        resume_state = tensors_from_checkpoint(
            load_checkpoint(checkpoint_path), device=case.device, dtype=dtype)
        if "params" in resume_state:
            params = resume_state["params"]

    if params is None:
        params = case.init_params(seed, dtype)
    results = {}
    phase_names = [p.name for p in case.phases]
    skip_until = None
    if resume_state is not None and resume_state.get("phase") in phase_names:
        skip_until = resume_state["phase"]

    for phase in case.phases:
        if skip_until is not None and phase.name != skip_until:
            continue  # phase completed before the checkpoint was taken
        maxiter = (maxiter_override or {}).get(phase.name, phase.maxiter)
        init_carry = None
        base_iters = 0  # phase iterations completed before this call
        if skip_until is not None and phase.name == skip_until:
            skip_until = None
            if resume_state.get("lbfgs_carry") is not None:
                init_carry = tuple(resume_state["lbfgs_carry"])
                base_iters = int(resume_state.get("iters", 0))
                maxiter = max(0, maxiter - base_iters)
                if maxiter == 0:
                    params = _merge_resumed(case, phase, params, init_carry[0])
                    continue
        if (phase.name == case.phases[-1].name and case.adam_iters
                and init_carry is None):
            ar = run_adam(case.loss_and_aux_fn(phase.loss), params,
                          case.adam_lr, iters=case.adam_iters,
                          log_every=log_every)
            params = ar.params
        sub_fn, sub0, merge = _phase_loss_fn(case, phase, params)

        on_segment = None
        if checkpoint_path:
            seg_count = [0]

            def on_segment(k, sub_params, hist, *, carry=None, _phase=phase,
                           _merge=merge, _params=params, _count=seg_count,
                           _base=base_iters):
                _count[0] += 1
                if _count[0] % checkpoint_every_segments == 0:
                    save_checkpoint(checkpoint_path, {
                        "params": _merge(_params, sub_params),
                        "phase": _phase.name,
                        # cumulative across resumes, so that a second
                        # resume subtracts the right base.
                        "iters": _base + k,
                        "lbfgs_carry": carry,
                    })

        res = lbfgs_mod.minimize(
            sub_fn, sub0, maxiter=maxiter, ftol=phase.ftol,
            log_every=log_every, on_segment=on_segment, segment=segment,
            init_carry=init_carry,
        )
        params = merge(params, res.params)
        results[phase.name] = res
        if on_phase_end is not None:
            on_phase_end(phase, params, res)
    return params, results


def _merge_resumed(case: Case, phase: Phase, params, sub_params):
    """Merge a checkpointed subtree back when a resumed phase has no budget
    left (the checkpoint was taken at or past the phase's maxiter)."""
    if phase.trainable is None:
        return sub_params
    return path_set(params, phase.trainable, sub_params)
