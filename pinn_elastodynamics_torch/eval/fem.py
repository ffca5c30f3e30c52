"""FEM ground-truth loading (.mat probe frames).

Counterpart of ``pinn_elastodynamics_tpu/eval/fem.py``, a numpy and
``scipy.io`` copy.  It mirrors the reference's ``preprocess``
(PlateHoleQuarter/train/train.py:658-676;
ElasticWaveConfined/ElasticWave.py:541-565): per-frame ``ProbeData-<i>.mat``
files with keys x, y, u, v, s11, s22, s12 and, for the wave cases, amp and
Mises.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import scipy.io

BASE_KEYS = ("x", "y", "u", "v", "s11", "s22", "s12")
WAVE_KEYS = BASE_KEYS + ("amp", "Mises")


def load_frame(fem_dir: str, frame: int) -> Dict[str, np.ndarray]:
    """Load one FEM probe frame as flat (N,) float arrays."""
    path = os.path.join(fem_dir, f"ProbeData-{frame}.mat")
    data = scipy.io.loadmat(path)
    out = {}
    for k in WAVE_KEYS:
        if k in data:
            out[k] = np.asarray(data[k]).ravel().astype(np.float64)
    return out


def frame_count(fem_dir: str) -> int:
    n = 0
    while os.path.exists(os.path.join(fem_dir, f"ProbeData-{n}.mat")):
        n += 1
    return n
