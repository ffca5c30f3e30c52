"""Field-evaluation serving (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/serving.py``.  A trained model is a
queryable field: given (x, y[, z]) points and a time, return displacements,
stresses and strains.

* :class:`FieldEvaluator` — an evaluator around a model and its parameters,
  on one device (the GPU unless the CPU is asked for), serving any batch in
  fixed-size chunks: on a CUDA device each chunk is one replay of a CUDA
  graph of the chunk's forward, captured at the first request;
* :class:`FieldServer` — a small stdlib HTTP server exposing it as JSON
  (``POST /predict`` {"points": [[x, y], ...], "t": t, "fields": [...]}),
  with ``GET /healthz`` and ``GET /meta``.
"""

from __future__ import annotations

import json
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .device import resolve_device
from .eval.render import _predict_chunk, padded_points, predict_fields, with_amp
from .kernels import fused_jet
from .utils.profiling import span

# How the evaluators' chunks ran: replays of a chunk's CUDA graph, eager
# forwards, graphs captured, and captures that raised (their evaluators
# serve eagerly); always on (``reset_chunks`` clears it).  Evaluators serve
# from request threads at once, so this module adds to it, and to the
# launches a replay runs, under ``_COUNTS``.
CHUNKS = {"graph": 0, "eager": 0, "captures": 0, "capture_errors": 0}
_COUNTS = threading.Lock()


def reset_chunks() -> None:
    with _COUNTS:
        for name in CHUNKS:
            CHUNKS[name] = 0


def _count(name: str, n: int = 1) -> None:
    with _COUNTS:
        CHUNKS[name] += n


def _params_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _params_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_params_to(v, device, dtype) for v in tree]
    return tree.detach().to(device=device, dtype=dtype, copy=True,
                            memory_format=torch.contiguous_format)


class _HostConstants(TorchFunctionMode):
    """Tensors that a forward makes on a CUDA device from Python numbers
    (``torch.as_tensor`` or ``torch.tensor`` of a number, list or tuple,
    such as a model's ``lb`` and ``ub``): made once, in the warm-up before
    a capture, and handed back when the capture makes them again, since a
    synchronous copy from the host cannot be captured."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in (torch.as_tensor, torch.tensor) and args
                and isinstance(args[0], (int, float, list, tuple))
                and torch.device(kwargs.get("device") or "cpu").type == "cuda"):
            key = (func.__name__, repr(args), repr(sorted(kwargs.items())))
            if key not in self.made:
                self.made[key] = func(*args, **kwargs)
            return self.made[key]
        return func(*args, **kwargs)


class _ChunkGraph:
    """``_predict_chunk`` of one (chunk, ndim + 1) input captured as a CUDA
    graph: the static ``input``, and one static (F, chunk) ``output`` that
    holds every field the forward computes on the device, in the order of
    ``names`` (the channels, then the strains).  The parameters are read
    from their device memory at every replay, so they must not change; so
    is every tensor the forward made in the warm-up and the capture reuses
    (``_HostConstants``), which the graph therefore holds as long as it
    lives: freed, its memory could be handed to another allocation."""

    def __init__(self, model, params, chunk: int, dtype, device):
        self.input = torch.zeros((chunk, model.spec.ndim + 1), dtype=dtype,
                                 device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.constants = constants = _HostConstants()
        with torch.cuda.device(device):
            # Warm up on the capture's stream (the kernel library, cuBLAS's
            # handle, the host constants), then capture into a private pool.
            # In "thread_local" mode another thread's CUDA calls cannot
            # fault the capture.
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream), constants:
                self.names = list(_predict_chunk(model, params, self.input))
            torch.cuda.current_stream().wait_stream(stream)
            before = dict(fused_jet.LAUNCHES)
            try:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    with constants:
                        fields = _predict_chunk(model, params, self.input)
                        self.output = torch.stack(
                            [fields[k] for k in self.names])
            finally:
                # The capture counted launches that ran no kernel; each
                # replay runs them.
                self.launches = {k: fused_jet.LAUNCHES[k] - before[k]
                                 for k in before}
                with _COUNTS:
                    for k, v in self.launches.items():
                        fused_jet.LAUNCHES[k] -= v
        _count("captures")

    def replay(self) -> None:
        self.graph.replay()
        with _COUNTS:
            CHUNKS["graph"] += 1
            for k, v in self.launches.items():
                fused_jet.LAUNCHES[k] += v


class FieldEvaluator:
    """Evaluator of one model on one device; serves any batch in chunks.

    The parameters are copied to ``device`` in ``dtype`` once, here (a copy
    even where they are there already), so a later change to the caller's
    tensors reaches no answer.  On a CUDA device the first request captures
    the chunk's forward as a CUDA graph (``_ChunkGraph``); every request
    then pads its points once into pinned host memory and runs each chunk
    as a copy in, one replay and one copy of the graph's output back, all
    asynchronous, with one wait for the request.  Should the capture raise,
    the evaluator serves eagerly (``predict_fields``) for its lifetime.
    """

    def __init__(self, model, params, *, chunk: int = 8192,
                 dtype=np.float32, name: str = "model", device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.chunk = chunk
        self.dtype = dtype
        self.name = name
        self._tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        self.params = _params_to(params, self.device, self._tdtype)
        self._lock = threading.Lock()
        # The chunk's graph: None until the first request on a CUDA
        # device, False after a capture that raised.
        self._graph = None
        # Pinned host buffers, grown to the largest request: its padded
        # points, and per chunk the graph's output.
        self._points: Optional[torch.Tensor] = None
        self._fields: Optional[torch.Tensor] = None

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
                if self._graph is None and self.device.type == "cuda":
                    self._graph = self._capture()
                if self._graph:
                    out = self._replayed(xy, float(t))
                else:
                    _count("eager", -(-xy.shape[0] // self.chunk))
                    out = predict_fields(
                        self.model, self.params, xy, float(t),
                        chunk=self.chunk, dtype=self.dtype,
                        device=self.device,
                    )
            if fields:
                unknown = set(fields) - set(out)
                if unknown:
                    raise KeyError(f"unknown fields: {sorted(unknown)}")
                out = {k: out[k] for k in fields}
        return out

    def _capture(self):
        """The chunk's graph, or False where capturing it raised."""
        try:
            return _ChunkGraph(self.model, self.params, self.chunk,
                               self._tdtype, self.device)
        except Exception as e:  # any fault of the capture: serve eagerly
            _count("capture_errors")
            warnings.warn(f"{self.name}: capturing the chunk's CUDA graph "
                          f"raised {e!r}; serving eagerly")
            return False

    def _buffers(self, n_chunks: int):
        """The pinned buffers, grown to hold ``n_chunks`` chunks."""
        if self._fields is None or self._fields.shape[0] < n_chunks:
            width = self.model.spec.ndim + 1
            self._points = torch.empty((n_chunks * self.chunk, width),
                                       dtype=self._tdtype, pin_memory=True)
            self._fields = torch.empty(
                (n_chunks, len(self._graph.names), self.chunk),
                dtype=self._tdtype, pin_memory=True)
        return self._points, self._fields

    def _replayed(self, xy: np.ndarray, t: float) -> Dict[str, np.ndarray]:
        """Every field at ``xy`` by replays of the chunk's graph.  Spans as
        ``predict_fields``'s, but ``graph`` = 1 and one ``render.d2h``, the
        request's one wait, after the chunks."""
        graph, chunk, n = self._graph, self.chunk, xy.shape[0]
        n_chunks = -(-n // chunk)
        points, fields = self._buffers(n_chunks)
        padded_points(xy, t, points.numpy()[: n_chunks * chunk])
        with torch.cuda.device(self.device):
            for i in range(n_chunks):
                rows = min(chunk, n - i * chunk)
                with span("render.chunk", rows=rows, pad=chunk - rows,
                          graph=1):
                    with span("render.h2d"):
                        graph.input.copy_(points[i * chunk : (i + 1) * chunk],
                                          non_blocking=True)
                    with span("render.jet"):
                        graph.replay()
                    fields[i].copy_(graph.output, non_blocking=True)
            with span("render.d2h"):
                torch.cuda.current_stream().synchronize()
        with span("render.merge"):
            # Each answer owns its arrays: the next request overwrites the
            # pinned buffers.
            host = fields.numpy()[:n_chunks]
            out = {name: np.concatenate(host[:, k])[:n]
                   for k, name in enumerate(graph.names)}
            return with_amp(out)

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
