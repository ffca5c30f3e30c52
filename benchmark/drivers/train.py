"""The training driver: L-BFGS windows through the program's ``minimize``.

Set-up builds one training object from the seed: the banks, the weights on
the device, and the program's phase loss over the trainable subtree,
wrapped by a counter of evaluations.  Every step, from the first, goes
through the same call, ``minimize(..., init_carry=carry)`` in segments,
with the same counter: the first ``check_steps`` steps one at a time, each
recorded for the check; then the warm-up, until the curvature memory is
full; then the window, segments until ``--seconds`` have passed.  The
window's rate is the real collocation rows times the value+grads completed,
over the window.

Once the window has closed, the peak memory read and the program's state
freed, the reference (float64) follows the program from the program's own
iterates.  Of the recorded first steps: the loss at each, the first
gradient as the optimizer held it after one step, and the parameters'
change over the steps.  Of the window: the update that ended its first
segment, made with a full memory that has wrapped round (the reference's
two-loop over the pairs of the program's m + 1 iterates before it and the
reference's gradients there, times the program's step size); the loss and
gradient at the window's last iterate; and the updates that the state
handed from segment to segment counts, against the iterations that the
window ran.  The window runs in segments, so the iterates before an
update are read from the optimizer state that the update left: the newest
point and the memory's differences of points lead back to them.  Nothing
else of that state is read but its count of updates.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from .. import weights as wt
from ..core import Parts, Run, sync
from ..reference import compare, lbfgs as ref_lbfgs


class Counted:
    """The loss handed to ``minimize``: counts evaluations and, in a traced
    run, records each value+grad as a host span (from the call to the
    gradient of the last trainable leaf, through hooks on the leaves),
    synchronised at both edges while ``sync_spans`` is set."""

    def __init__(self, fn, run: Run):
        self.fn, self.run = fn, run
        self.evals = 0
        self.spans = run.trace
        self.sync_spans = False

    def __call__(self, sub):
        self.evals += 1
        if self.spans:
            dev, sync_edges = self.run.device, self.sync_spans
            if sync_edges:
                sync(dev)
            t0 = time.perf_counter()
            leaves = [t for layer in sub for t in (layer["W"], layer["b"])
                      if t.requires_grad]
            left = [len(leaves)]

            def done(grad):
                # the last leaf's gradient ends the backward
                left[0] -= 1
                if left[0] == 0:
                    if sync_edges:
                        sync(dev)
                    self.run.spans.add("loss_eval", t0, time.perf_counter())
                return grad

            for t in leaves:
                t.register_hook(done)
        return self.fn(sub)


def _flat(sub) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1) for layer in sub
                      for t in (layer["W"], layer["b"])]).double().cpu().numpy()


def _launches() -> int:
    from pinn_elastodynamics_torch.kernels import fused_jet, fused_jet_vjp

    return sum(fused_jet.LAUNCHES.values()) + sum(fused_jet_vjp.LAUNCHES.values())


def control_loss(adapter, ref, weights: dict, host_banks: dict, device):
    """The control: the reference in TF32 put in the program's place."""
    def fn(sub):
        trainable = [(layer["W"], layer["b"]) for layer in sub]
        nets = adapter.reference_nets(weights, trainable, "tf32", device)
        return sum(ref.loss_blocks(nets, host_banks, "tf32", device))

    return fn, wt.program_tree(weights[adapter.TRAINABLE])


def reference_value_grad(adapter, ref, weights: dict, host_banks: dict,
                         x: np.ndarray, device, need_grad: bool):
    """(loss, gradient or None) of the reference in float64 at the
    trainable vector ``x``, block by block."""
    vec = torch.as_tensor(x, dtype=torch.float64, device=device)
    vec.requires_grad_(need_grad)
    trainable = wt.unflat(vec, weights[adapter.TRAINABLE])
    nets = adapter.reference_nets(weights, trainable, "float64", device)
    total = 0.0
    with torch.set_grad_enabled(need_grad):
        for part in ref.loss_blocks(nets, host_banks, "float64", device):
            if need_grad:
                part.backward()
            total += float(part.detach())
    grad = vec.grad.cpu().numpy() if need_grad else None
    return total, grad


def drive(run: Run, adapter, *, fault=None, control=False) -> dict:
    """Set up, measure and check one training run; returns the readings
    of the check.  ``fault`` plants ``"frozen_step"`` (every call returns
    the state it was given), ``"frozen_window"`` (so, in the window only)
    or ``"half_batch"`` (the program's banks keep every other row, the
    means taken over those); ``control`` puts the reference in TF32 in the
    program's place."""
    from pinn_elastodynamics_torch.train.lbfgs import minimize

    cfg, traffic, dev = run.config, run.traffic, run.device
    ref = importlib.import_module(f"benchmark.reference.{adapter.REFERENCE}")
    host_banks = adapter.banks(cfg, run.seed)
    weights = wt.make(cfg["nets"], run.seed, dev)
    if control:
        sub_fn, sub0 = control_loss(adapter, ref, weights, host_banks, dev)
    else:
        sub_fn, sub0 = adapter.program(cfg, host_banks, weights, dev, fault)
    counted = Counted(sub_fn, run)
    memory, seg, ftol = traffic["memory"], traffic["segment"], traffic["ftol"]
    in_window = [False]

    def advance(carry, n):
        res = minimize(counted, carry[0], maxiter=n, segment=n, ftol=ftol,
                       memory_size=memory, init_carry=carry)
        if fault == "frozen_step" or (fault == "frozen_window"
                                      and in_window[0]):
            return carry, res.n_iters
        return res.carry, res.n_iters

    # The state before the first step (one evaluation, at the start), then
    # the recorded steps.
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
    in_window[0] = True
    carry, after_first = _window(run, counted, advance, carry, seg)
    run.flops = adapter.train_flops(cfg, host_banks)
    run.counts["rows"] = adapter.real_rows(host_banks)
    if dev.type == "cuda":
        run.memory_peak_bytes = max(torch.cuda.max_memory_allocated(d)
                                    for d in range(torch.cuda.device_count()))
    window = {"update": _last_iterates(after_first),
              "end": _last_iterates(carry),
              "updates": int(carry[1]["count"]) - count_start}
    del carry, after_first, counted, sub_fn, sub0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return _check(run, adapter, ref, weights, host_banks, first, window)


def _last_iterates(carry) -> dict:
    """The last iterates of a carry as the program's optimizer state holds
    them (float64 on the host): the newest point ``x`` with its value and
    gradient, the step size of the last update, and the points that the
    memory's pairs span, ``xs``, oldest first, ending at the point the
    last update left.  After K updates the state holds x_{K-1} and the
    differences x_j - x_{j-1} of the newest min(K - 1, m) steps before it,
    each at slot (j - 1) mod m."""
    state = carry[1]
    count = int(state["count"])
    dw = state["diff_params_memory"].double().cpu().numpy()
    m = dw.shape[0]
    xs = [state["params"].double().cpu().numpy()]
    for j in range(count - 1, count - 1 - min(count - 1, m), -1):
        xs.append(xs[-1] - dw[(j - 1) % m])
    return {"x": _flat(carry[0]), "f": float(state["value"]),
            "g": state["grad"].double().cpu().numpy(),
            "step": float(state["learning_rate"]), "xs": xs[::-1],
            "count": count}


def _window(run: Run, counted: Counted, advance, carry, seg: int):
    """Segments of ``seg`` iterations until ``run.seconds`` have passed; a
    traced run's window in parts (``core.Parts``), each value+grad of the
    spans part timed between synchronisations.  Returns the last carry and
    the one that ended the first segment (kept as it is, not copied)."""
    parts = Parts(run)
    evals0, launches0, iters = counted.evals, _launches(), 0
    after_first = None
    t0 = parts.begin()
    while True:
        carry, n = advance(carry, seg)
        if after_first is None:
            after_first = carry
        iters += n
        now = time.perf_counter()
        part = parts.tick(now, {"evals": counted.evals - evals0,
                                "iters": iters})
        counted.sync_spans = part == "spans"
        if now - t0 >= run.seconds:
            break
    sync(run.device)
    t1 = time.perf_counter()
    parts.end({"evals": counted.evals - evals0, "iters": iters}, "lbfgs")
    run.window_s = t1 - t0
    run.counts.update(window_start=t0, window_end=t1,
                      evals=counted.evals - evals0, iters=iters,
                      launches=_launches() - launches0)
    run.attempted = counted.evals - evals0
    run.failed = int(not bool(torch.isfinite(carry[1]["value"])))
    return carry, after_first


def _check(run: Run, adapter, ref, weights, host_banks, first: dict,
           window: dict) -> dict:
    """The reference follows the recorded first steps, the window's first
    update and its last iterate; the gaps go to the run."""
    dev = run.device

    def value_grad(x, need_grad=True):
        return reference_value_grad(adapter, ref, weights, host_banks, x,
                                    dev, need_grad)

    xs, fs, steps = first["xs"], first["fs"], first["steps"]
    fr, gr = [], []
    for k, x in enumerate(xs):
        f, g = value_grad(x, k < len(steps))
        fr.append(f)
        gr.append(g)
    slices = wt.leaf_slices(weights[adapter.TRAINABLE])
    keep = compare.moving_leaves(gr[0], slices)
    change_ref = ref_lbfgs.change(xs, gr, steps)
    change = xs[-1] - xs[0]

    # The window's first update: the reference's gradients at the iterates
    # that the memory spans, its direction at the point the update left,
    # times the program's step size.
    upd, end = window["update"], window["end"]
    g_upd = [value_grad(x)[1] for x in upd["xs"]]
    step_ref = upd["step"] * ref_lbfgs.last_direction(upd["xs"], g_upd)
    step = upd["x"] - upd["xs"][-1]
    keep_upd = compare.moving_leaves(g_upd[-1], slices)
    f_end, g_end = value_grad(end["x"])
    iters = run.counts["iters"]
    readings = {
        "loss_gap": max(compare.relative_gap(p, r) for p, r in zip(fs, fr)),
        "grad_gap": compare.leaf_gap(first["g0"], gr[0], slices),
        "grad_vec_gap": compare.leaf_vec_gap(first["g0"], gr[0], slices),
        "step_gap": compare.leaf_gap(change, change_ref, slices, keep),
        "step_vec_gap": compare.leaf_vec_gap(change, change_ref, slices,
                                             keep),
        "window_step_vec_gap": compare.leaf_vec_gap(step, step_ref, slices,
                                                    keep_upd),
        # Late in a run the worst leaf of the gradient swings from seed to
        # seed (float32 rounding of a small gradient): the whole vectors
        # are compared.
        "end_loss_gap": compare.relative_gap(end["f"], f_end),
        "end_grad_gap": compare.vec_gap(end["g"], g_end),
        "window_updates_lost": (iters - window["updates"]) / max(iters, 1),
    }
    for name, value in readings.items():
        run.check(name, value)
    run.counts["leaves_left_out"] = int((~keep).sum() + (~keep_upd).sum())
    run.counts["window_pairs"] = len(upd["xs"]) - 1
    return readings
