"""Point banks: fixed-shape, maskable collocation/boundary point sets.

Counterpart of ``pinn_elastodynamics_tpu/banks.py``.  Each point family
(collocation, IC, per-edge boundary, hole surface, distance regression) is a
:class:`PointBank` of tensors on one device, with a validity mask so that a
bank padded to a multiple of some size gives the same loss (masked means
divide by the true point count).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device


@dataclasses.dataclass
class PointBank:
    """A batch of sample points plus per-point attached data.

    Attributes:
      xyt:    (N, A) coordinates, time last.
      mask:   (N,) 1.0 for real points, 0.0 for padding.
      values: named per-point tensors, each (N, K) — boundary targets,
              normals, regression targets, etc.
      mesh:   the ``parallel.mesh.Mesh`` this bank is one rank's shard of
              (``shard_bank``), or None; the losses over a sharded bank
              sum their masked means over the mesh's ranks.
    """

    xyt: torch.Tensor
    mask: torch.Tensor
    values: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mesh: Optional[object] = None

    @property
    def n_total(self) -> int:
        return self.xyt.shape[0]


def make_bank(
    pts: np.ndarray,
    values: Optional[Dict[str, np.ndarray]] = None,
    *,
    dtype=torch.float32,
    pad_to_multiple_of: int = 1,
    device="cuda",
) -> PointBank:
    """Build a PointBank on ``device`` from host arrays, padding N up to a
    multiple.  Padding rows get mask 0 and contribute nothing to masked
    means."""
    dev = resolve_device(device)
    pts = np.asarray(pts)
    n = pts.shape[0]
    n_pad = (-n) % pad_to_multiple_of

    def pad(a):
        a = np.asarray(a)
        if a.ndim == 1:
            a = a[:, None]
        return np.pad(a, [(0, n_pad)] + [(0, 0)] * (a.ndim - 1))

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    mask = np.concatenate([np.ones(n), np.zeros(n_pad)])
    return PointBank(
        xyt=tensor(pad(pts)),
        mask=tensor(mask),
        values={k: tensor(pad(v)) for k, v in (values or {}).items()},
    )


class ChunkSumCollector:
    """Collects per-chunk partial sums of every masked square-and-mean.

    The device side of the host-f64 loss (train/lbfgs_host.py): instead of
    one f32-rounded scalar per loss component, the device emits
    ``n_chunks`` partial sums, which the host adds in float64, so the loss
    resolves to about eps32/n_chunks instead of eps32.

    Entries are appended on every evaluation, so use a fresh collector per
    call.  ``names``, ``arrays`` and ``counts`` line up entry by entry.
    """

    def __init__(self, chunk_size: int = 512):
        self.chunk_size = chunk_size
        self.names = []    # component name per entry
        self.arrays = []   # (n_chunks,) chunk sums per entry, r's dtype
        self.counts = []   # 0-d valid-point count per entry

    def add(self, name: str, r: torch.Tensor, mask: torch.Tensor):
        if r.ndim > 1:
            r = r.reshape(r.shape[0])
        q = r * r * mask
        pad = (-q.shape[0]) % self.chunk_size
        if pad:
            q = torch.cat([q, q.new_zeros(pad)])
        self.names.append(name)
        self.arrays.append(q.reshape(-1, self.chunk_size).sum(dim=1))
        self.counts.append(torch.sum(mask))


def masked_mean_square(r: torch.Tensor, mask: torch.Tensor,
                       dtype=None) -> torch.Tensor:
    """mean(r²) over valid points — the reference's reduce_mean(square).

    ``dtype`` upcasts the square-and-reduce tail while the residuals stay in
    the network's compute dtype.
    """
    if r.ndim > 1:
        r = r.reshape(r.shape[0])
    if dtype is not None:
        r = r.to(dtype)
        mask = mask.to(dtype)
    return torch.sum(r * r * mask) / torch.clamp(torch.sum(mask), min=1.0)


def bank_sizes(banks: Dict[str, PointBank]) -> Dict[str, int]:
    return {k: b.n_total for k, b in banks.items()}
