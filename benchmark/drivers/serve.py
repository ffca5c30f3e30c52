"""The serving driver: a closed loop of one client on the program's
``FieldEvaluator.evaluate``.

The traffic file sets the mix.  Requests come from a deck that every seed
shares (so many frames, so many probes of fixed sizes); the seed shuffles
the deck anew each time round, places the probes' points and picks the
times.  A frame asks for every field at the ``frame_points`` points of one
grid (a stand-in of the FEM probe grid, drawn once per run) at one of the
configuration's ``frames`` frame times; a probe asks at its own points
outside the hole at any time.  The client sends the next request when the last has returned,
until ``--seconds`` have passed.

A sample of the requests, drawn from the seed over the whole window
(reservoir sampling), is kept with its answers; once the window has closed
the reference (float64) answers the same points and the widest gap of any
field decides ``correct``.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from .. import samplers as smp
from .. import weights as wt
from ..core import Parts, Run, sync
from ..reference import compare
from ..reference.mlp import cast_net


def deck(traffic: dict) -> list:
    """(kind, points) of every request of one round of the deck."""
    out = []
    for entry in traffic["deck"]:
        if entry["kind"] == "frame":
            out += [("frame", traffic["frame_points"])] * entry["count"]
        else:
            lo, hi, n = entry["min_points"], entry["max_points"], entry["count"]
            out += [("probe", int(round(lo * (hi / lo) ** ((i + 0.5) / n))))
                    for i in range(n)]
    return out


def requests(config: dict, traffic: dict, seed: int):
    """The endless stream of (kind, xy float32 (N, 2), t) requests over the
    configuration's domain (a square less a hole at the origin) and
    frame times."""
    rng = np.random.default_rng([seed, 1])
    dom = config["serve_domain"]
    lo, hi, r = dom["lo"], dom["hi"], dom["hole_r"]
    max_t, frames = config["max_t"], config["frames"]
    grid = smp.points_outside_disk(rng, traffic["frame_points"], lo, hi,
                                   r=r).astype(np.float32)
    rounds = deck(traffic)
    while True:
        for i in rng.permutation(len(rounds)):
            kind, n = rounds[i]
            if kind == "frame":
                t = float(rng.integers(frames)) * max_t / (frames - 1)
                yield kind, grid, t
            else:
                xy = smp.points_outside_disk(rng, n, lo, hi, r=r)
                t = float(np.float32(rng.uniform(0.0, max_t)))
                yield kind, xy.astype(np.float32), t


def _faulty(evaluate, fault):
    """The evaluator with a fault planted where its answer is made."""
    if fault is None:
        return evaluate

    def half(xy, t):
        n = xy.shape[0]
        out = evaluate(xy[: (n + 1) // 2], t)
        return {k: np.concatenate([v, np.zeros(n - v.shape[0], v.dtype)])
                for k, v in out.items()}

    def altered(xy, t):
        out = evaluate(xy, t)
        for v in out.values():
            v[0] = v[1]
        return out

    return {"half_batch": half, "altered_answer": altered}[fault]


def drive(run: Run, adapter, *, fault=None, control=False) -> dict:
    """Set up, measure and check one serving run; returns the readings of
    the check.  ``fault`` plants ``"half_batch"`` (half of each request's
    points answered, zeros for the rest) or ``"altered_answer"`` (each
    field's first point given the second's value); ``control`` puts the
    reference in TF32 in the evaluator's place."""
    cfg, traffic, dev = run.config, run.traffic, run.device
    ref = importlib.import_module(f"benchmark.reference.{adapter.REFERENCE}")
    weights = wt.make(cfg["nets"], run.seed, dev)
    if control:
        nets = {k: cast_net(v, "tf32", dev) for k, v in weights.items()}

        def evaluate(xy, t):
            xyt = np.concatenate(
                [xy, np.full((xy.shape[0], 1), t, np.float32)], axis=1)
            out = ref.fields(nets, xyt, "tf32", dev)
            return {k: v.astype(np.float32) for k, v in out.items()}
    else:
        from pinn_elastodynamics_torch.serving import FieldEvaluator

        ev = FieldEvaluator(adapter.serve_model(),
                            adapter.serve_params(weights),
                            chunk=traffic["chunk"], device=dev)
        evaluate = ev.evaluate
    evaluate = _faulty(evaluate, fault)
    stream = requests(cfg, traffic, run.seed)
    # Warm-up: every chunk of every request has the one padded shape.
    for kind in ("frame", "probe"):
        while True:
            k, xy, t = next(stream)
            if k == kind:
                evaluate(xy, t)
                break
    sync(dev)
    run.mark_setup_done()
    kept = _window(run, evaluate, stream,
                   np.random.default_rng([run.seed, 2]))
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    evaluate = ev = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.flops = adapter.serve_flops_per_point(cfg)
    return _check(run, ref, weights, kept)


def _window(run: Run, evaluate, stream, rng) -> list:
    """Requests until ``run.seconds`` have passed (a traced run's window in
    parts, ``core.Parts``); returns the sample kept for the check."""
    size = run.traffic["check_requests"]
    parts = Parts(run)
    kept, seen, points = [], 0, 0
    t0 = parts.begin()
    while True:
        kind, xy, t = next(stream)
        s = time.perf_counter()
        try:
            out = evaluate(xy, t)
        except Exception:   # a failed request counts; the run goes on
            out = None
        e = time.perf_counter()
        run.attempted += 1
        if out is None:
            run.failed += 1
            run.latencies.append((kind, float("inf"), s))
        else:
            points += xy.shape[0]
            run.latencies.append((kind, e - s, s))
            run.spans.add("serve.request", s, e)
            # reservoir sampling: each answer kept with equal chance
            seen += 1
            if len(kept) < size:
                kept.append((xy, t, out))
            else:
                j = int(rng.integers(seen))
                if j < size:
                    kept[j] = (xy, t, out)
        parts.tick(e, {"points": points})
        if e - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    parts.end({"points": points}, "client")
    run.window_s = t1 - t0
    run.counts.update(window_start=t0, window_end=t1, points=points)
    return kept


def _check(run: Run, ref, weights: dict, kept: list) -> dict:
    nets = {k: cast_net(v, "float64", run.device) for k, v in weights.items()}
    refs = []
    for xy, t, _ in kept:
        xyt = np.concatenate([xy.astype(np.float64),
                              np.full((xy.shape[0], 1), np.float32(t),
                                      np.float64)], axis=1)
        refs.append(ref.fields(nets, xyt, "float64", run.device))
    scale = {k: max(1e-30, max(float(np.abs(r[k]).max()) for r in refs))
             for k in ref.FIELDS}
    gap = max((compare.field_gap(out, r, scale)
               for (_, _, out), r in zip(kept, refs)), default=float("inf"))
    run.check("field_gap", gap)
    run.counts["checked_requests"] = len(kept)
    return {"field_gap": gap}
