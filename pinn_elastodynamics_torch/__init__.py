"""PyTorch/CUDA port of the PINN elastodynamics framework.

A second package beside ``pinn_elastodynamics_tpu`` (the JAX reference),
written for one NVIDIA H100.  It covers the quarter-plate case, the
three elastic-wave cases and the 3D case (with its plane-wave MMS oracle)
end to end, and serving: jet algebra, the tanh-MLP jet, the field models
(net-BC composite, Fourier features, closed-form hard BCs), residuals and
traction, point banks, declarative losses, the cases and their phases,
value+grad and the microbatched loss for 1M+ point banks, Adam, L-BFGS
with a zoom line search, the extended-precision endgame (float64
parameters over float32 compute, ``mixed_precision_phase_fn``; host
float64 L-BFGS over chunk-summed losses, ``train/lbfgs_host.py``), the
phase pipeline and the time-horizon curriculum with checkpoint and
resume, the CLI (``python -m pinn_elastodynamics_torch.run``), rendering
and the HTTP field server, the FEM comparison, the inverse problem,
adaptive sampling, data parallelism over the points axis
(``parallel/mesh.py``: sharded banks, replicated parameters, the masked
means and the gradient summed over the ranks; ``parallel/launch.py``: a
world of ranks, NCCL with one per card), and the framework's entry points
(``entry.py``: the flagship forward and a multi-rank dry run).
The fused jets and their backward run as hand-written CUDA kernels
(kernels/csrc/), built with ``nvcc`` at first use and reached through
autograd Functions (kernels/fused_jet_vjp.py); this module does not load
them.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .device import resolve_device
from .models.analytic_bc import AnalyticCompositeFieldModel
from .models.fields import (
    CompositeFieldModel,
    FieldSpec,
    FIRST_ORDER,
    MLPFieldModel,
    SECOND_ORDER,
)
from .models.fourier import FourierMLPFieldModel
from .ops.jet import Jet

__version__ = "0.1.0"

__all__ = [
    "AnalyticCompositeFieldModel",
    "CompositeFieldModel",
    "FieldSpec",
    "FIRST_ORDER",
    "FourierMLPFieldModel",
    "Jet",
    "MLPFieldModel",
    "SECOND_ORDER",
    "resolve_device",
]
