"""Field rendering on evaluation grids (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/eval/render.py``: one jet forward
produces every field and the strains, over chunks padded to a fixed size.
Which jet runs is the model's choice (``jet_impl``): with ``"auto"`` a
chunk on the GPU goes through the fused CUDA kernels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.residuals import strains_2d
from ..utils.profiling import span


@torch.no_grad()
def _predict_chunk(model, params, xyt: torch.Tensor) -> Dict[str, torch.Tensor]:
    jet = model.jet(params, xyt, order=1)
    spec = model.spec
    out = {name: jet.f[:, spec.index(name)] for name in spec.channels}
    if spec.ndim == 2:
        e11, e22, e12 = strains_2d(jet, spec)
        out.update({"e11": e11, "e22": e22, "e12": e12})
    return out


def predict_fields(
    model, params, xy: np.ndarray, t: float, *,
    chunk: int = 65536, dtype=np.float32, device="cuda",
) -> Dict[str, np.ndarray]:
    """Evaluate all fields + strains at spatial points ``xy`` and time ``t``.

    ``params`` must live on ``device`` in ``dtype``.  Points are padded to
    whole chunks of ``chunk`` rows (the padding rows are dropped from the
    result), so every chunk has one shape.  Spans: ``render.chunk`` (its
    real ``rows`` and its ``pad``) around ``render.h2d`` (padding and the
    copy to the device), ``render.jet`` (the forward's enqueue) and
    ``render.d2h`` (the fields' copies back, the first of which waits for
    the forward); then ``render.merge``.
    """
    dev = resolve_device(device)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    n = xy.shape[0]
    tcol = np.full((n, 1), t)
    pts = np.concatenate([xy, tcol], axis=1).astype(dtype)
    outs = []
    for start in range(0, n, chunk):
        block = pts[start : start + chunk]
        pad = chunk - block.shape[0]
        with span("render.chunk", rows=block.shape[0], pad=pad):
            with span("render.h2d"):
                if pad:
                    block = np.pad(block, ((0, pad), (0, 0)))
                xyt = torch.as_tensor(block, dtype=tdtype, device=dev)
            with span("render.jet"):
                res = _predict_chunk(model, params, xyt)
            with span("render.d2h"):
                outs.append({k: v[: chunk - pad].cpu().numpy()
                             for k, v in res.items()})
    with span("render.merge"):
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        merged["amp"] = np.sqrt(merged["u"] ** 2 + merged["v"] ** 2)
    return merged


def predict_frames(model, params, xy: np.ndarray, times, **kw):
    """Yield (t, fields) over a frame sequence."""
    for t in times:
        yield t, predict_fields(model, params, xy, float(t), **kw)
