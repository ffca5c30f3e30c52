"""A world of ranks, one process each: the launcher for data parallelism.

:func:`run_world` runs a picklable rank function in ``n`` spawned processes
joined in one process group and returns every rank's result.  Each rank
gets the mesh of its group (``parallel.mesh.make_mesh``) and the caller's
payload:

- ``device="cuda"`` (the default): NCCL, rank r on ``cuda:r``, one rank per
  card; fewer cards than ranks raises before anything is spawned.  With
  ``backend="gloo"`` the ranks go on ``cuda:{r % cards}`` instead, the
  explicit way to run more ranks than the machine has cards (NCCL refuses
  two ranks on one card);
- ``device="cpu"``: gloo, only when asked for.

The ranks rendezvous through a ``FileStore`` in a temporary directory.  The
payload (parameter trees and the like) reaches them through a file there:
a large ``Process`` argument would hold each ``start()`` until the child
has imported its module.  Each rank writes its result, or its traceback,
to a file of its own.  The parent waits for them against one deadline; a
rank that fails ends the world at once (the others would wait in a
collective until the group's timeout), and the parent raises with that
rank's traceback.  On the card the kernel library is built once, in the
parent, before any rank starts; on the CPU each rank runs one intra-op
thread, since the ranks share the host's cores.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 60     # the process group's limit on one collective
TIMEOUT_S = 600          # default limit on the whole world, spawn to exit
_KILL_S = 10             # grace after terminate() before kill()


def _plan(n: int, device: str, backend: Optional[str]):
    """(backend, [device of each rank]); raises on a world the machine
    cannot hold."""
    if n < 1:
        raise ValueError(f"a world needs at least one rank, not {n}")
    kind = torch.device(device).type
    if kind == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: NCCL reduces "
                             "CUDA tensors only; use gloo")
        return backend, ["cpu"] * n
    if kind != "cuda":
        raise ValueError(f"device {device!r}: a world runs on 'cuda' or 'cpu'")
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and cards < n:
        raise RuntimeError(
            f"{n} NCCL ranks need {n} CUDA devices, one each; "
            f"{cards} present (backend='gloo' shares the cards)")
    if cards < 1:
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return backend, [f"cuda:{r % cards}" for r in range(n)]


def _rank_main(fn, rank: int, size: int, backend: str, device: str,
               root: str) -> None:
    """One rank: join the group, run ``fn(mesh, payload)`` and write its
    result (or the traceback) to ``root/rank<rank>.pkl``."""
    from .mesh import make_mesh

    path = os.path.join(root, f"rank{rank}.pkl")

    def write(out):   # whole or not at all: the parent may read it early
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            os.environ["LOCAL_RANK"] = str(dev.index)
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        with open(os.path.join(root, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(root, "store"), size),
            rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            write({"result": fn(make_mesh(device=dev), payload)})
        finally:
            dist.destroy_process_group()
    except BaseException:
        # Written before the group goes: the ranks waiting on this one
        # fail after it, and so write their errors later.
        if not os.path.exists(path):
            write({"error": traceback.format_exc()})
        raise


def _stop(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.terminate()
    for p in started:
        p.join(_KILL_S)
        if p.is_alive():
            p.kill()
            p.join()


def run_world(fn: Callable, n: int, *, device: str = "cuda",
              backend: Optional[str] = None, timeout_s: float = TIMEOUT_S,
              payload=None) -> List:
    """``fn(mesh, payload)`` in each of ``n`` spawned ranks; the results in
    rank order.

    ``fn`` must be picklable (a module-level function) and so must its
    result.  Raises ``RuntimeError`` with the first failing rank's
    traceback, or ``TimeoutError`` if the world has not ended within
    ``timeout_s`` seconds; either way no rank is left running.
    """
    backend, devices = _plan(n, device, backend)
    if devices[0].startswith("cuda"):
        from ..kernels import _native

        _native.build()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, backend, devices[r], root))
                 for r in range(n)]
        deadline = time.monotonic() + timeout_s
        results = {}
        try:
            for p in procs:
                p.start()
            while len(results) < n:
                left = deadline - time.monotonic()
                running = [p.sentinel for r, p in enumerate(procs)
                           if r not in results]
                if left <= 0 or not multiprocessing.connection.wait(
                        running, timeout=left):
                    raise TimeoutError(
                        f"world of {n} ({backend}): ranks "
                        f"{sorted(set(range(n)) - set(results))} still "
                        f"running after {timeout_s} s")
                for r, p in enumerate(procs):
                    if r in results or p.is_alive():
                        continue
                    p.join()
                    out = _load(root, r)
                    if "result" not in out or p.exitcode != 0:
                        raise _failure(root, procs, results, n, backend)
                    results[r] = out["result"]
        finally:
            _stop(procs)
    return [results[r] for r in range(n)]


def _load(root: str, rank: int) -> dict:
    path = os.path.join(root, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        return pickle.load(f)


def _failure(root, procs, results, n, backend) -> RuntimeError:
    """The error of the rank that failed first: a rank that ended without
    writing an error (a signal, a crash) if there is one, else the first
    error written, since the ranks that wait on a failed rank fail after
    it."""
    first = None
    for r, p in enumerate(procs):
        if r in results:
            continue
        out = _load(root, r)
        if "error" in out:
            written = os.stat(os.path.join(root, f"rank{r}.pkl")).st_mtime_ns
        elif p.is_alive():
            continue
        else:
            written = -1
        if first is None or written < first[0]:
            first = (written, r, out.get("error", "no error written"))
    _, r, error = first
    return RuntimeError(f"rank {r} of a world of {n} ({backend}) failed "
                        f"(exit code {procs[r].exitcode}):\n{error}")
