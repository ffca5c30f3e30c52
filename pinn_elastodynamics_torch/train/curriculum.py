"""Time-horizon curriculum with warm-start checkpoints.

Counterpart of ``pinn_elastodynamics_tpu/train/curriculum.py``.  The
reference converges the wave cases by training a short horizon, saving the
pickle, rebuilding the problem with a longer MAX_T, and reloading ("train
7s → 14s", ElasticWaveConfined/ElasticWave.py:884,1003; "10s → 15s → 25s",
ElasticWaveInfinite/ElasticWave.py:636,742).  Here that is a schedule: a
list of (max_t, maxiter) stages over a case builder that accepts ``max_t``;
parameters flow between stages and each stage checkpoints atomically.
L-BFGS starts cold in each stage, as in the reference, since the banks
change between stages; within a stage a live checkpoint carries the
optimizer state, so a stage cut short resumes where it stopped.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..utils.logging import MetricLogger
from .adam import run_adam
from .checkpoint import load_checkpoint, save_checkpoint, tensors_from_checkpoint
from .lbfgs import minimize


@dataclasses.dataclass(frozen=True)
class Stage:
    max_t: float
    maxiter: int
    adam_iters: int = 0
    adam_lr: float = 1e-3
    # Stop the stage early once the loss reaches this (e.g. the reference
    # pickle's own loss on the same banks — the convergence bar).
    target: float = -float("inf")
    # Flat-step patience for the stage's L-BFGS (consecutive zero-decrease
    # steps before stopping).  minimize()'s default of 5 reads an f32
    # line-search storm as convergence; 100 rides the storms out.
    patience: int = 100
    # L-BFGS iterations per segment, the host hook (and the live
    # checkpoint) running between segments.
    segment: int = 25
    # Cold starts and mid-storm resumes are the storm-prone regimes; a
    # warm-up block of extra-short segments runs first.
    warmup_iters: int = 100
    warmup_segment: int = 10


def run_time_curriculum(
    case_builder: Callable,  # kwargs incl. max_t, device, dtype -> Case
    stages: Sequence[Stage],
    *,
    params=None,
    seed: int = 1111,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    log_every: int = 0,
    logger: Optional[MetricLogger] = None,
    builder_kwargs: Optional[dict] = None,
    device="cuda",
    dtype=torch.float32,
) -> Tuple[object, List[dict]]:
    """Run the horizon-extension schedule; returns (params, stage_summaries).

    Each stage's case is ``case_builder(max_t=stage.max_t, device=device,
    dtype=dtype, **builder_kwargs)``; parameters (fresh ones from ``seed``
    when ``params`` is None) live on ``device`` in ``dtype``.  With
    ``checkpoint_dir`` each completed stage is written atomically as
    ``stage_<k>_T<max_t>.ckpt`` and, when ``resume`` is set, completed
    stages are skipped on restart and a stage cut short continues from its
    live checkpoint ``stage_<k>_live.ckpt`` (parameters and the L-BFGS
    carry, written after every segment).
    """
    builder_kwargs = builder_kwargs or {}
    summaries: List[dict] = []

    def on_device(tree):
        return tensors_from_checkpoint(tree, device=device, dtype=dtype)

    for k, stage in enumerate(stages):
        ck_path = (
            os.path.join(checkpoint_dir, f"stage_{k}_T{stage.max_t:g}.ckpt")
            if checkpoint_dir else None
        )
        if ck_path and resume and os.path.exists(ck_path):
            state = load_checkpoint(ck_path)
            params = on_device(state["params"])
            summaries.append({**state["summary"], "resumed": True})
            continue

        case = case_builder(max_t=stage.max_t, device=device, dtype=dtype,
                            **builder_kwargs)
        if params is None:
            params = case.init_params(seed=seed, dtype=dtype)

        # Mid-stage recovery: the live checkpoint carries the full L-BFGS
        # state (curvature memory, last value and gradient), so a stage
        # that was cut continues where it stopped instead of restarting
        # cold.
        live_path = (
            os.path.join(checkpoint_dir, f"stage_{k}_live.ckpt")
            if checkpoint_dir else None
        )
        init_carry, done_iters = None, 0
        if live_path and resume and os.path.exists(live_path):
            live = on_device(load_checkpoint(live_path))
            if live.get("lbfgs_carry") is not None:
                init_carry = tuple(live["lbfgs_carry"])
                done_iters = int(live.get("iters", 0))
                params = live["params"]

        t0 = time.perf_counter()
        if stage.adam_iters and init_carry is None:
            ar = run_adam(
                case.loss_and_aux_fn(), params, stage.adam_lr,
                iters=stage.adam_iters, log_every=log_every,
            )
            params = ar.params

        if done_iters >= stage.maxiter:
            # The live checkpoint already reached the stage budget; score
            # the checkpointed parameters as they are.
            with torch.no_grad():
                final_loss = float(case.loss_fn(case.loss)(params))
            iters_total = done_iters
        else:
            # A short-segment warm-up block chained into the production
            # block: cold starts and mid-storm resumes run zoom storms
            # where one iteration costs up to 50 value+grads.
            loss = case.loss_fn(case.loss)
            remaining = stage.maxiter - done_iters
            blocks = []
            if stage.warmup_iters and remaining > 0:
                n = min(stage.warmup_iters, remaining)
                blocks.append((n, stage.warmup_segment))
                remaining -= n
            if remaining > 0:
                blocks.append((remaining, stage.segment))

            carry = init_carry
            iters_total = done_iters
            final_loss = None
            for n_block, seg in blocks:
                def on_segment(it, p, hist, *, carry=None, _live=live_path,
                               _base=iters_total):
                    save_checkpoint(_live, {
                        "params": p, "iters": _base + it,
                        "lbfgs_carry": carry,
                    })

                res = minimize(
                    loss, params, maxiter=n_block, log_every=log_every,
                    init_carry=carry, segment=seg,
                    on_segment=on_segment if live_path else None,
                    target=stage.target, patience=stage.patience,
                )
                params = res.params
                carry = res.carry
                final_loss = float(res.final_loss)
                iters_total += int(res.n_iters)
                if int(res.n_iters) < n_block:
                    break  # done: patience / gtol / nonfinite / target
        wall = time.perf_counter() - t0
        summary = {
            "stage": k,
            "max_t": stage.max_t,
            "iters": iters_total,
            "final_loss": final_loss,
            "wall_seconds": wall,
        }
        summaries.append(summary)
        if logger is not None:
            logger.log({"event": "curriculum_stage", **summary})
        if ck_path:
            save_checkpoint(ck_path, {"params": params, "summary": summary})
        if live_path and os.path.exists(live_path):
            os.unlink(live_path)  # superseded by the stage checkpoint

    return params, summaries
