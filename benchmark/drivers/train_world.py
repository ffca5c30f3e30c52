"""The training driver over a world of ranks: L-BFGS windows through the
program's ``minimize``, data parallel.

The run's process starts the program's own world,
``parallel/launch.py::run_world``, with one rank per card it was given
(NCCL; gloo on the CPU).  Each rank sets up as ``drivers/train.py`` does,
but over its share of the banks (the adapter's ``program``, through the
program's ``shard_banks`` and ``replicate``), and steps in lockstep with
the others: every value+grad sums the loss's sums and counts, and then the
gradient, over the ranks.  Rank 0 alone reads the clock.  Once per segment
it sends every rank, over a gloo group of its own (host memory only, so
that no kernel of its own shows in the device trace), whether the window
stops and which part of a traced window it is in; the ranks stop on the
same segment and change parts together, so none is left waiting in an
all-reduce that the others never join.

The ranks return to the run's process: rank 0 its recorded iterates and
optimizer state (as ``drivers/train.py`` records them), its counts, its
device trace and its set-up time; every rank its final parameters, its
``mesh.all_reduce`` spans of the gradient in the profiled part, its peak
memory and the forbidden modules it loaded.  After the world has ended,
the run's process checks rank 0's record against the reference in float64
on the whole, unsharded banks, as ``drivers/train.py`` does, and reads
``ranks_param_gap``: the largest difference between any rank's final
parameters and rank 0's, which lockstep ranks keep at 0.

``setup_s`` runs from the run's start to rank 0's end of warm-up, both on
the host's monotonic clock (``time.perf_counter``), which the processes
share.  The rate is the global real collocation rows times the
value+grads, over rank 0's window.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from .. import weights as wt
from ..core import Parts, Run, forbidden_loaded, sync
from . import train
from .train import Counted, _flat, _last_iterates, _launches, control_loss

PARTS = ("plain", "profile", "spans")


def drive(run: Run, adapter, *, fault=None, control=False) -> dict:
    """Run the world, then check rank 0's record; returns the readings of
    the check.  ``fault`` plants the adapter's ``"half_batch"`` or
    ``"dropped_allreduce"`` (each rank optimises its own shard alone);
    ``control`` puts the reference in TF32 in the program's place, on the
    whole banks in every rank."""
    from pinn_elastodynamics_torch.parallel import launch

    payload = {"adapter": adapter.__name__, "cell": run.cell,
               "config": run.config, "traffic": run.traffic,
               "seed": run.seed, "seconds": run.seconds, "trace": run.trace,
               "t_start": run.t_start, "fault": fault, "control": control}
    ranks = launch.run_world(
        _rank, run.chips, device=run.device.type, payload=payload,
        timeout_s=launch.TIMEOUT_S + run.seconds)
    bad = sorted({m for out in ranks for m in out["forbidden"]})
    if bad:
        raise RuntimeError(f"forbidden modules loaded in a rank: {bad}")
    lead = ranks[0]
    run.setup_s, run.window_s = lead["setup_s"], lead["window_s"]
    run.counts.update(lead["counts"])
    run.attempted, run.failed = lead["attempted"], lead["failed"]
    run.device_trace = lead["device_trace"]
    run.memory_peak_bytes = max(out["memory_peak_bytes"] for out in ranks)
    for r, out in enumerate(ranks):
        run.counts[f"iters.rank{r}"] = out["iters"]
        for t0, t1 in out["grads_spans"]:
            run.spans.add(f"mesh.all_reduce.grads.rank{r}", t0, t1)
    ready = [out["ready_s"] for out in ranks]
    print(f"world: {len(ranks)} ranks ready for their first collective "
          f"{min(ready):.2f}-{max(ready):.2f} s after the run's start",
          file=sys.stderr, flush=True)

    cfg, dev = run.config, run.device
    ref = importlib.import_module(f"benchmark.reference.{adapter.REFERENCE}")
    host_banks = adapter.banks(cfg, run.seed)
    weights = wt.make(cfg["nets"], run.seed, dev)
    run.flops = adapter.train_flops(cfg, host_banks)
    run.counts["rows"] = adapter.real_rows(host_banks)
    readings = _check_on_cards(run, adapter, ref, weights, host_banks,
                               lead["first"], lead["window"])
    gap = max(float(np.max(np.abs(out["x"] - lead["x"]))) for out in ranks)
    run.check("ranks_param_gap", gap)
    readings["ranks_param_gap"] = gap
    return readings


def _check_on_cards(run: Run, adapter, ref, weights, host_banks,
                    first: dict, window: dict) -> dict:
    """``drivers/train.py``'s check, with the reference's value+grads at
    the points it reads computed beforehand, the points spread over the
    run's cards (a thread each)."""
    if run.device.type == "cuda":
        devices = [torch.device("cuda", d) for d in range(run.chips)]
    else:
        devices = [run.device]
    n_steps = len(first["steps"])
    points = ([(x, k < n_steps) for k, x in enumerate(first["xs"])]
              + [(x, True) for x in window["update"]["xs"]]
              + [(window["end"]["x"], True)])
    known = {}

    def work(d: int) -> None:
        dev = devices[d]
        on_dev = {k: [(w.to(dev), b.to(dev)) for w, b in net]
                  for k, net in weights.items()}
        for x, need_grad in points[d::len(devices)]:
            known[x.tobytes(), need_grad] = train.reference_value_grad(
                adapter, ref, on_dev, host_banks, x, dev, need_grad)

    with ThreadPoolExecutor(len(devices)) as pool:
        for job in [pool.submit(work, d) for d in range(len(devices))]:
            job.result()

    def lookup(adapter, ref, weights, host_banks, x, device, need_grad):
        return known[x.tobytes(), need_grad]

    # train._check asks reference_value_grad for each point in turn
    with mock.patch.object(train, "reference_value_grad", lookup):
        return train._check(run, adapter, ref, weights, host_banks, first,
                            window)


def _rank(mesh, p: dict) -> dict:
    """One rank's run: set-up, the first steps, the warm-up and the window,
    as ``drivers/train.py::drive`` runs them, in lockstep with the other
    ranks."""
    from pinn_elastodynamics_torch.train.lbfgs import minimize

    adapter = importlib.import_module(p["adapter"])
    cfg, traffic, dev = p["config"], p["traffic"], mesh.device
    run = Run(cell=p["cell"], config=cfg, traffic=traffic, seed=p["seed"],
              seconds=p["seconds"], trace=p["trace"], device=dev,
              chips=mesh.size, t_start=p["t_start"], limits={})
    lead = mesh.rank == 0
    # The window's messages go over the host, never through the device.
    talk = dist.new_group(backend="gloo")
    host_banks = adapter.banks(cfg, run.seed)
    weights = wt.make(cfg["nets"], run.seed, dev)
    if dev.type == "cuda":
        from pinn_elastodynamics_torch.kernels import _native

        _native.library()
    sync(dev)
    ready_s = time.perf_counter() - run.t_start
    if p["control"]:
        from pinn_elastodynamics_torch.parallel.mesh import replicate

        ref = importlib.import_module(
            f"benchmark.reference.{adapter.REFERENCE}")
        sub_fn, sub0 = control_loss(adapter, ref, weights, host_banks, dev)
        sub0 = replicate(sub0, mesh)
    else:
        sub_fn, sub0 = adapter.program(cfg, host_banks, weights, mesh,
                                       p["fault"])
    del host_banks
    counted = Counted(sub_fn, run)
    counted.spans = False   # no reader of this cell times single value+grads
    memory, seg, ftol = traffic["memory"], traffic["segment"], traffic["ftol"]

    def advance(carry, n):
        res = minimize(counted, carry[0], maxiter=n, segment=n, ftol=ftol,
                       memory_size=memory, init_carry=carry)
        return res.carry, res.n_iters

    carry = minimize(counted, sub0, maxiter=0, ftol=ftol,
                     memory_size=memory).carry
    first = {"xs": [_flat(carry[0])], "fs": [float(carry[1]["value"])],
             "steps": [], "g0": None}
    for _ in range(traffic["check_steps"]):
        carry, _ = advance(carry, 1)
        state = carry[1]
        if first["g0"] is None:
            first["g0"] = state["updates"].double().cpu().numpy()
        first["xs"].append(_flat(carry[0]))
        first["fs"].append(float(state["value"]))
        first["steps"].append(float(state["learning_rate"]))
    left = traffic["warm_iters"] - traffic["check_steps"]
    while left > 0:
        carry, n = advance(carry, min(seg, left))
        left -= max(n, 1)
    count_start = int(carry[1]["count"])
    sync(dev)
    run.mark_setup_done()
    carry, after_first, spans = _window(run, mesh.rank, talk, counted,
                                        advance, carry, seg)
    out = {"x": _flat(carry[0]), "iters": run.counts["iters"],
           "grads_spans": spans, "ready_s": ready_s,
           "forbidden": forbidden_loaded(), "memory_peak_bytes": (
               torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
               else 0)}
    if lead:
        out.update(
            setup_s=run.setup_s, window_s=run.window_s,
            counts=dict(run.counts), attempted=run.attempted,
            failed=run.failed, device_trace=run.device_trace, first=first,
            window={"update": _last_iterates(after_first),
                    "end": _last_iterates(carry),
                    "updates": int(carry[1]["count"]) - count_start})
    del carry, after_first, counted, sub_fn, sub0
    gc.collect()
    return out


def _reduced_bytes() -> dict:
    """The bytes the program's all-reduces have summed on this rank (its
    ``COLLECTIVE_BYTES``), or nothing from a program that does not count
    them."""
    from pinn_elastodynamics_torch.parallel import mesh as pmesh

    counted = getattr(pmesh, "COLLECTIVE_BYTES", None)
    if counted is None:
        return {}
    return {"allreduce_bytes": counted["sums"] + counted["grads"]}


def _grads_spans(t0: float, t1: float) -> list:
    """(start, end) of this rank's ``mesh.all_reduce`` spans of the
    gradient that opened between ``t0`` and ``t1``, in order; none from a
    program without them."""
    from pinn_elastodynamics_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    return [(s.start, s.end) for s in read()
            if s.name == "mesh.all_reduce" and s.counts.get("kind") == "grads"
            and t0 <= s.start < t1]


def _window(run: Run, rank: int, talk, counted: Counted, advance, carry,
            seg: int):
    """Segments of ``seg`` iterations until rank 0's clock says
    ``run.seconds`` have passed, a traced run's window in parts
    (``core.Parts``) moved on rank 0's word.  Returns the last carry, the
    one that ended the first segment, and this rank's spans of the
    gradient's all-reduce in the profiled part."""
    parts = Parts(run)
    evals0, launches0, iters = counted.evals, _launches(), 0
    bytes0 = _reduced_bytes()
    after_first = None
    word = torch.zeros(2, dtype=torch.int64)
    t0 = parts.begin()
    while True:
        carry, n = advance(carry, seg)
        if after_first is None:
            after_first = carry
        iters += n
        counts = {"evals": counted.evals - evals0, "iters": iters}
        counts.update({k: v - bytes0[k] for k, v in _reduced_bytes().items()})
        if rank == 0:
            now = time.perf_counter()
            word[0] = PARTS.index(parts.tick(now, counts))
            word[1] = int(now - t0 >= run.seconds)
        dist.broadcast(word, src=dist.get_global_rank(talk, 0), group=talk)
        while parts.part != PARTS[int(word[0])]:
            # rank 0's part, whatever this rank's clock says; only rank 0's
            # times are reported
            parts.tick(math.inf, counts)
        if word[1]:
            break
    sync(run.device)
    t1 = time.perf_counter()
    parts.end(counts, "lbfgs")
    traced = parts.trace is not None and parts.part != "plain"
    spans = _grads_spans(parts.trace.t0, parts.trace.t1) if traced else []
    run.window_s = t1 - t0
    run.counts.update(window_start=t0, window_end=t1, evals=counts["evals"],
                      iters=iters, launches=_launches() - launches0)
    run.attempted = counts["evals"]
    run.failed = int(not bool(torch.isfinite(carry[1]["value"])))
    return carry, after_first, spans
