"""Residual-based adaptive collocation sampling (beyond-reference).

Counterpart of ``pinn_elastodynamics_tpu/geometry/adaptive.py``.  The
reference refines sampling statically — hand-placed LHS boxes near the
stress concentration and the wave source (train.py:904; SURVEY.md §2 #14).
This module adds the dynamic version from the PINN literature: evaluate
the PDE residual on a candidate pool and move the worst-sampled regions
into the collocation bank.

Two strategies:
  * ``topk_refine`` — RAR: swap the top-k residual candidates in.
  * ``residual_resample`` — importance resampling: draw a whole new bank
    with probability ∝ residual^power (plus a uniform floor to keep
    coverage).

Both keep bank shapes fixed: refine swaps out the k lowest-residual
existing points rather than growing the array.  The residuals are
forward-only jets under ``torch.no_grad()``; on the GPU they run through
the fused forward kernels (B1, or B4 for a net-BC composite).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..banks import PointBank
from ..ops import residuals as res_ops
from ..ops.elasticity import Material
from ..utils.tree import tree_leaves


@torch.no_grad()
def pointwise_residual_norm(
    model, params, mat: Material, plane: str, xyt: torch.Tensor
) -> torch.Tensor:
    """Per-point L2 norm across all PDE residual channels — the sampling
    signal."""
    jet = model.jet(params, xyt)
    res = res_ops.residuals(jet, model.spec, mat, plane)
    total = sum(r * r for r in res.values())
    return torch.sqrt(total)


def _top_indices(r: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, largest first; ties go to the
    lower index, as ``jax.lax.top_k``'s do (``torch.topk`` leaves their
    order unspecified, and padding rows tie at infinity)."""
    return torch.sort(r, descending=True, stable=True).indices[:k]


@torch.no_grad()
def topk_refine(
    model, params, mat: Material, plane: str,
    bank: PointBank, candidates: np.ndarray, k: int,
) -> Tuple[PointBank, dict]:
    """RAR step: replace the bank's k lowest-residual points with the k
    highest-residual candidates (bank shape unchanged).

    Padding rows (mask 0) are replaced before any real point is evicted.
    Only value-free banks (collocation) are taken.
    """
    if bank.values:
        raise ValueError(
            "topk_refine only supports value-free banks (collocation)"
        )
    cand = torch.as_tensor(candidates, dtype=bank.xyt.dtype,
                           device=bank.xyt.device)
    r_cand = pointwise_residual_norm(model, params, mat, plane, cand)
    r_bank = pointwise_residual_norm(model, params, mat, plane, bank.xyt)
    # Padding rows get -inf so they are evicted first.
    r_bank = torch.where(bank.mask > 0, r_bank,
                         torch.full_like(r_bank, -torch.inf))

    worst_cand = _top_indices(r_cand, k)          # best candidates
    best_bank = _top_indices(-r_bank, k)          # weakest bank slots

    new_xyt = bank.xyt.clone()
    new_xyt[best_bank] = cand[worst_cand]
    new_mask = bank.mask.clone()
    new_mask[best_bank] = 1.0
    evicted = r_bank[best_bank]
    info = {
        "replaced": k,
        "cand_residual_mean": float(torch.mean(r_cand[worst_cand])),
        "evicted_residual_mean": float(torch.mean(
            torch.where(torch.isfinite(evicted), evicted,
                        torch.zeros_like(evicted)))),
    }
    return PointBank(xyt=new_xyt, mask=new_mask, values={}), info


def residual_resample(
    model, params, mat: Material, plane: str,
    pool: np.ndarray, n: int, *,
    power: float = 1.0, uniform_floor: float = 0.1,
    seed: int = 0, batch: int = 65536,
) -> np.ndarray:
    """Importance-resample ``n`` points from a candidate pool with
    p ∝ (1-floor)·residual^power/Σ + floor·uniform.

    The pool is evaluated in batches of ``batch`` points, rounded to f32
    (as JAX does) on the parameters' device and in their dtype; the draw
    is numpy's ``default_rng(seed).choice`` on the host."""
    pool = np.asarray(pool)
    like = tree_leaves(params)[0]
    rs = []
    for start in range(0, pool.shape[0], batch):
        chunk = torch.as_tensor(pool[start : start + batch].astype(np.float32),
                                device=like.device).to(like.dtype)
        rs.append(pointwise_residual_norm(model, params, mat, plane, chunk)
                  .cpu().numpy())
    r = np.concatenate(rs) ** power
    p = r / max(r.sum(), 1e-30)
    p = (1.0 - uniform_floor) * p + uniform_floor / pool.shape[0]
    p /= p.sum()
    rng = np.random.default_rng(seed)
    idx = rng.choice(pool.shape[0], size=n, replace=True, p=p)
    return pool[idx]
