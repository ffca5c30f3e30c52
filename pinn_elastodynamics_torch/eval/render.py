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


def padded_points(xy: np.ndarray, t: float, out: np.ndarray) -> np.ndarray:
    """Write the points ``[xy, t]`` of ``xy`` (N, ndim) into the first N
    rows of ``out`` (at least N rows, ndim + 1 columns, in the forward's
    dtype) and zeros into the rest: the padded layout every chunk takes."""
    n, ndim = xy.shape
    out[:n, :ndim] = xy
    out[:n, ndim] = t
    out[n:] = 0
    return out


def with_amp(fields: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``fields`` with ``amp``, the displacement's magnitude, computed on
    the host from ``u`` and ``v``."""
    fields["amp"] = np.sqrt(fields["u"] ** 2 + fields["v"] ** 2)
    return fields


def predict_fields(
    model, params, xy: np.ndarray, t: float, *,
    chunk: int = 65536, dtype=np.float32, device="cuda",
) -> Dict[str, np.ndarray]:
    """Evaluate all fields + strains at spatial points ``xy`` and time ``t``.

    ``params`` must live on ``device`` in ``dtype``.  Points are padded to
    whole chunks of ``chunk`` rows (the padding rows are dropped from the
    result), so every chunk has one shape.  Spans: ``render.chunk`` (its
    real ``rows``, its ``pad`` and ``graph`` = 0: no chunk here is a graph
    replay) around ``render.h2d`` (the copy to the device), ``render.jet``
    (the forward's enqueue) and ``render.d2h`` (the fields' copies back,
    the first of which waits for the forward); then ``render.merge``.
    """
    dev = resolve_device(device)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    n = xy.shape[0]
    pts = padded_points(
        xy, t, np.empty((-(-n // chunk) * chunk, xy.shape[1] + 1), dtype))
    outs = []
    for start in range(0, n, chunk):
        rows = min(chunk, n - start)
        with span("render.chunk", rows=rows, pad=chunk - rows, graph=0):
            with span("render.h2d"):
                xyt = torch.as_tensor(pts[start : start + chunk],
                                      dtype=tdtype, device=dev)
            with span("render.jet"):
                res = _predict_chunk(model, params, xyt)
            with span("render.d2h"):
                outs.append({k: v[:rows].cpu().numpy()
                             for k, v in res.items()})
    with span("render.merge"):
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        with_amp(merged)
    return merged


def predict_frames(model, params, xy: np.ndarray, times, **kw):
    """Yield (t, fields) over a frame sequence."""
    for t in times:
        yield t, predict_fields(model, params, xy, float(t), **kw)
