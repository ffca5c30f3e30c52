"""Field-evaluation serving (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/serving.py``.  A trained model is a
queryable field: given (x, y[, z]) points and a time, return displacements,
stresses and strains.

* :class:`FieldEvaluator` — an evaluator around a model and its parameters,
  on one device (the GPU unless the CPU is asked for), serving any batch in
  fixed-size chunks;
* :class:`FieldServer` — a small stdlib HTTP server exposing it as JSON
  (``POST /predict`` {"points": [[x, y], ...], "t": t, "fields": [...]}),
  with ``GET /healthz`` and ``GET /meta``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .eval.render import predict_fields
from .utils.profiling import span


def _params_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _params_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_params_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype).contiguous()


class FieldEvaluator:
    """Evaluator of one model on one device; serves any batch in chunks.

    The parameters are copied to ``device`` in ``dtype`` once, here.
    """

    def __init__(self, model, params, *, chunk: int = 8192,
                 dtype=np.float32, name: str = "model", device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.chunk = chunk
        self.dtype = dtype
        self.name = name
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        self.params = _params_to(params, self.device, tdtype)
        self._lock = threading.Lock()

    def warmup(self):
        self.evaluate(np.zeros((1, self.model.spec.ndim)), 0.0)
        return self

    def evaluate(
        self, xy: np.ndarray, t: float,
        fields: Optional[Sequence[str]] = None,
    ) -> Dict[str, np.ndarray]:
        """Every field at the points ``xy`` (N, ndim) and time ``t``, or
        the ``fields`` named.  One request: a ``serve.evaluate`` span with
        its ``points``, whose id every span under it carries as its root."""
        xy = np.asarray(xy, self.dtype)
        if xy.ndim != 2 or xy.shape[1] != self.model.spec.ndim:
            raise ValueError(
                f"points must be (N, {self.model.spec.ndim}), got {xy.shape}"
            )
        with span("serve.evaluate", points=xy.shape[0]):
            with self._lock:  # one device; serialize requests
                out = predict_fields(
                    self.model, self.params, xy, float(t),
                    chunk=self.chunk, dtype=self.dtype, device=self.device,
                )
            if fields:
                unknown = set(fields) - set(out)
                if unknown:
                    raise KeyError(f"unknown fields: {sorted(unknown)}")
                out = {k: out[k] for k in fields}
        return out

    @property
    def meta(self) -> dict:
        return {
            "name": self.name,
            "ndim": self.model.spec.ndim,
            "formulation": self.model.spec.formulation,
            "channels": list(self.model.spec.channels),
            "chunk": self.chunk,
        }


def _make_handler(evaluator: FieldEvaluator):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/meta":
                self._send(200, evaluator.meta)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                pts = np.asarray(req["points"], dtype=np.float64)
                t = float(req.get("t", 0.0))
                fields = req.get("fields")
                out = evaluator.evaluate(pts, t, fields)
                self._send(200, {
                    "n": int(pts.shape[0]),
                    "t": t,
                    "fields": {k: v.tolist() for k, v in out.items()},
                })
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class FieldServer:
    """Threaded HTTP server around a FieldEvaluator.

    Request threads and the serving thread are daemons; :meth:`stop` shuts
    the server down and joins the serving thread.
    """

    def __init__(self, evaluator: FieldEvaluator, host="127.0.0.1", port=0):
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(evaluator)
        )
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._httpd.server_address

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()
