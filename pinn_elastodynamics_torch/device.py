"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  When no GPU
is present and the CPU was not asked for, they raise instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU")
    return dev
