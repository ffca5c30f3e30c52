"""PyTorch/CUDA port of the PINN elastodynamics framework.

A second package beside ``pinn_elastodynamics_tpu`` (the JAX reference),
written for one NVIDIA H100.  This slice serves the quarter-plate field
models: jet algebra, the tanh-MLP jet, the field models (net-BC composite,
Fourier features, closed-form hard BCs), checkpoint reading, rendering and
the HTTP field server.  The fused jet forwards run as hand-written CUDA
kernels (kernels/csrc/fused_jet.cu), built with ``nvcc`` at first use; this
module does not load them.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
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
