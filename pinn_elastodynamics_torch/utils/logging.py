"""Structured metric logging.

Counterpart of ``pinn_elastodynamics_tpu/utils/logging.py``.  The reference
logs by ``print`` only: per-iteration loss via the L-BFGS callback,
every-10-step Adam prints, and one pickled loss-history list.  This module
writes a JSONL metric stream (step, per-term losses, wall clock) beside
stdout, cheap enough to leave on.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional

import numpy as np


class MetricLogger:
    """Append-only JSONL metric stream with optional stdout echo."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        echo: bool = False,
        stream: Optional[IO] = None,
    ):
        self._fh: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._echo = echo
        self._stream = stream or sys.stdout
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        record = {"t": round(time.time() - self._t0, 3), **record}
        line = json.dumps(record, default=_jsonify)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self._echo:
            print(line, file=self._stream)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonify(x):
    """numpy scalars and arrays as JSON values; anything else as its
    ``str``."""
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


class PhaseTimer:
    """Wall-clock phase timing (the reference's time.time() prints,
    train.py:966-969) as structured records."""

    def __init__(self, logger: MetricLogger, name: str):
        self._logger = logger
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._logger.log({
            "event": "phase_time",
            "phase": self._name,
            "seconds": time.perf_counter() - self._t0,
        })
