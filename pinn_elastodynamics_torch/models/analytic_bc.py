"""Exact hard-BC composite: u = P(x) + D(x)·ũ(x) with closed-form P and D.

Counterpart of ``pinn_elastodynamics_tpu/models/analytic_bc.py``.  The
distance factor D and particular field P are smooth closed-form functions
(per-case definitions live with their cases, e.g.
cases/plate_hole.py::analytic_dist/analytic_part); their jets come from
forward-mode AD (ops/jet.py::jet_of_fn) and only ũ ('uv') is a network.
The factors' jets and values open the span ``model.factors`` (``rows``;
``order``, 0 for the plain forward).

D and P take no parameters, so their results depend on the points alone:
each model keeps them per points tensor (``_FactorStore``) and a later call
on the same, unchanged tensor (a bank's ``xyt`` on every value+grad) reads
them back in place of recomputing them.  ``FACTOR_JETS`` counts how each
lookup went.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import torch
from torch.func import vmap
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.jet import Jet, jet_of_fn
from ..utils.profiling import span

# Lookups of the factors' store, one a ``jet`` or ``apply`` call: "hit"
# where D's and P's results for the points were read back, "miss" where
# they were computed and stored, "bypass" where they were computed and not
# stored (``_storable``).  Always on; cleared by reset_factor_jets().
FACTOR_JETS = {"hit": 0, "miss": 0, "bypass": 0}
_LOCK = threading.Lock()


def reset_factor_jets() -> None:
    with _LOCK:
        for name in FACTOR_JETS:
            FACTOR_JETS[name] = 0


def _storable(xyt: torch.Tensor) -> bool:
    """Whether the factors of ``xyt`` may be stored and read back: not for
    points that require grad, nor under a ``torch.func`` transform (its
    results are wrapped for that transform alone), nor in inference mode
    (its tensors cannot be saved for a later backward), nor while the
    stream captures a CUDA graph (each replay must compute the factors
    from its input buffer)."""
    return not (
        xyt.requires_grad
        or xyt.is_inference()
        or torch.is_inference_mode_enabled()
        or torch._C._functorch.is_functorch_wrapped_tensor(xyt)
        or torch._C._functorch.maybe_current_level() is not None
        or (xyt.is_cuda and torch.cuda.is_current_stream_capturing())
    )


class _FactorStore:
    """D's and P's results per points tensor, by the tensor's identity, as
    ``{(kind, order): (version, result)}``: an entry is read back only
    while the tensor's ``_version`` is the one it was filled at (an
    in-place change recomputes it), and goes when the tensor dies.  A copy
    or a pickle of the model starts empty."""

    def __init__(self):
        self.entries = WeakIdKeyDictionary()

    def __reduce__(self):
        return (_FactorStore, ())

    def clear(self) -> None:
        with _LOCK:
            self.entries.clear()

    def get(self, xyt: torch.Tensor, key, compute: Callable):
        """``compute()``'s (D, P) for ``xyt``, read back where stored."""
        if not _storable(xyt):
            with _LOCK:
                FACTOR_JETS["bypass"] += 1
            return compute()
        version = xyt._version
        with _LOCK:
            stored = self.entries.get(xyt, {}).get(key)
            if stored is not None and stored[0] == version:
                FACTOR_JETS["hit"] += 1
                return stored[1]
            FACTOR_JETS["miss"] += 1
        got = tuple(_detached(r) for r in compute())
        with _LOCK:
            self.entries.setdefault(xyt, {})[key] = (version, got)
        return got


def _detached(r):
    if isinstance(r, Jet):
        return Jet(*(None if t is None else t.detach()
                     for t in (r.f, r.d, r.dtt)))
    return r.detach()


@dataclasses.dataclass(frozen=True)
class AnalyticCompositeFieldModel:
    """u = P + D·ũ with closed-form D and P; only ũ ('uv') has parameters.

    ``dist_fn`` / ``part_fn`` map a single coordinate vector (A,) to the
    (C,) per-channel distance factor / particular values and must be smooth
    torch functions (vectorised with ``torch.func.vmap``).
    """

    spec: object                 # FieldSpec
    uv_model: object             # MLPFieldModel or FourierMLPFieldModel
    dist_fn: Callable
    part_fn: Callable
    _store: _FactorStore = dataclasses.field(
        default_factory=_FactorStore, init=False, repr=False, compare=False,
        hash=False)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        # The composite layout minus the learned factors, so
        # Phase(trainable="uv") works unchanged.
        return {"uv": self.uv_model.init(generator, dtype, device)}

    def jet(self, params, xyt: torch.Tensor, order: Optional[int] = None) -> Jet:
        order = self.spec.jet_order if order is None else order
        uv = self.uv_model.jet(params["uv"], xyt, order=order)
        with span("model.factors", rows=xyt.shape[0], order=order):
            dist, part = self._store.get(xyt, ("jet", order), lambda: (
                jet_of_fn(self.dist_fn, xyt, order=order),
                jet_of_fn(self.part_fn, xyt, order=order)))
        return part + dist * uv

    def apply(self, params, xyt: torch.Tensor) -> torch.Tensor:
        uv = self.uv_model.apply(params["uv"], xyt)
        with span("model.factors", rows=xyt.shape[0], order=0):
            part, dist = self._store.get(xyt, ("apply", 0), lambda: (
                vmap(self.part_fn)(xyt), vmap(self.dist_fn)(xyt)))
        return part + dist * uv
