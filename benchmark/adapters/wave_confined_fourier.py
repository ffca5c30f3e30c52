"""The elastic wave in a confined plate with hard BCs and 64 Fourier
features (W2): its banks from the seed, the program's loss over them, and
the work it needs.

The banks are W1's (``wave_confined.py``), drawn in the same order; the
hard BCs leave the IC and edge rows out of the loss, so only the
collocation and source banks are kept.  The case is the program's
``cases/wave_confined.build(bc="hard", fourier=64)``: u = P + D·ũ with
closed-form P and D, and ũ a tanh MLP of the Fourier embedding
[sin(2π·xn·B), cos(2π·xn·B)].  Its one phase trains ``uv.mlp``, with B
frozen, as the repo's run that met the reference loss bar did.

The benchmark's weights come as (W, b) nets, so B is the weight of the
one-layer net ``embed`` (3 -> 64) divided by that net's Glorot factor and
times the configuration's feature scale; ``embed``'s bias is unused.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import flops as fl
from ..weights import program_tree
from . import wave_confined as w1
from .plate_netbc import program_banks

REFERENCE = "wave_confined_fourier"
TRAINABLE = "mlp"
BANKS = ("collocation", "src")
# The feature scale the reference's B is made with; the configuration
# states the same (``feature_scale``), and ``program`` holds it to this.
FEATURE_SCALE = 1.0


def banks(cfg: dict, seed: int) -> dict:
    drawn = w1.banks(cfg, seed)
    return {k: drawn[k] for k in BANKS}


def feature_matrix(weights: dict) -> torch.Tensor:
    """B (3, F) from the weight of the net ``embed``, in its dtype."""
    ((w, _),) = weights["embed"]
    fan_in, fan_out = w.shape
    return w * (FEATURE_SCALE / math.sqrt(2.0 / (fan_in + fan_out)))


def program(cfg: dict, banks: dict, weights: dict, device, fault=None):
    """(sub_fn, sub0): the program's one phase with ``uv.mlp`` trained and
    B frozen, as ``run_pipeline`` hands it to ``minimize``."""
    from pinn_elastodynamics_torch.cases import wave_confined
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn

    if cfg["feature_scale"] != FEATURE_SCALE:
        raise ValueError(f"feature_scale {cfg['feature_scale']} is not the "
                         f"adapter's {FEATURE_SCALE}")
    case = wave_confined.build(scale=1e-3, max_t=cfg["max_t"], bc="hard",
                               fourier=cfg["n_features"],
                               fourier_scale=cfg["feature_scale"],
                               jet_impl="auto", device=device)
    case.banks = program_banks(cfg, banks, device, fault)
    phase = dataclasses.replace(case.phases[-1], trainable=cfg["trainable"])
    params = {"uv": {"B": feature_matrix(weights),
                     "mlp": program_tree(weights[TRAINABLE])}}
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    return sub_fn, sub0


def reference_nets(weights: dict, trainable, precision: str, device) -> dict:
    """The reference's nets: ``trainable`` (a list of (W, b)) as the MLP,
    and B made as the program's, then cast to the precision's dtype."""
    from ..reference.mlp import dtype_of

    b = feature_matrix(weights).to(device=device, dtype=dtype_of(precision))
    return {"B": b, TRAINABLE: trainable}


real_rows = w1.real_rows


def train_flops(cfg: dict, banks: dict) -> dict:
    """Operations of one value+grad of the loss (``step``): on the
    collocation rows the embedding, the MLP's order-1 jet (value and three
    tangents) from it and its backward, on the source rows the embedding
    and the MLP's value+grad; the closed-form factors are elementwise and
    not counted.  And of the backward stage B3b per launch as the loss
    needs it (``bwd``): the MLP's backward over the four streams, without
    the seed cotangent, which a frozen B does not need."""
    dims = cfg["nets"][TRAINABLE]
    a, f = cfg["nets"]["embed"]
    embed = 2 * a * f + 2 * f   # xn·B, and one sine and one cosine a feature
    n_col = real_rows(banks)
    n_src = banks["src"]["xyt"].shape[0]
    streams = 4
    step = (n_col * (fl.value_and_grad(dims, streams) + embed)
            + n_src * (fl.value_and_grad(dims, 1) + embed))
    first = fl.weights(dims)[0]
    bwd = n_col * (fl.bwd(dims, streams) - 2 * streams * first)
    # the seed streams and the stream cotangents read
    bwd_bytes = n_col * 4 * streams * (dims[0] + dims[-1])
    return {"step": float(step), "bwd": float(bwd),
            "bwd_bytes": float(bwd_bytes)}
