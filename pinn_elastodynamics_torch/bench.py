"""The port's benchmark: collocation-point residual evaluations/s on the card.

    python -m pinn_elastodynamics_torch.bench [--device cuda|cpu] [--scale S]
        [--blocked-iters N] [--lbfgs-iters N] [--cpu-scale F] [--cpu-iters N]
        [--skip-cpu] [--skip-lbfgs] [--skip-stt] [--stt-scale S]
        [--stt-threshold L] [--stt-maxiter N]

Counterpart of the JAX repo's ``bench.py``, function for function.  It
times the hot op of PINN training, one value+grad of the full weighted loss
of the flagship quarter plate with a hole (net-BC composite: uv 3→8×70→5,
dist and part 3→4×20→5; 103,711 collocation points at scale 1.0), the
uv-phase value+grad that L-BFGS repeats, the one-launch composite forward
against the three launches it replaced, the L-BFGS iteration rate warm and
cold, a CPU comparator of the same value+grad, and the wall time of the
from-scratch uv phase to a loss threshold (``seconds_to_target``,
BASELINE.md metric #1 at bench timescales).

It prints ONE JSON line with ``bench.py``'s keys wherever the quantity is
the same::

    {"metric": "collocation_evals_per_sec", "value": N, "unit": "evals/s",
     "vs_baseline": R, "device": {...}, "correct": true, ...}

Differences from ``bench.py``, each on purpose:

* No fallback hides a failure: a measurement that raises ends the bench.
  A measurement is left out only by its ``--skip-*`` flag, and its keys
  then read ``null``.
* No card, no bench: with ``--device cuda`` (the default) and no card,
  :func:`main` raises.  ``--device cpu`` runs every measurement on the CPU
  through the kernels' plain versions, for rehearsal and tests; the line's
  ``device`` then says ``cpu``.
* Before timing anything, :func:`check_outputs` holds the first full-loss
  and uv-phase value+grads against the eager float64 route on the same
  device and the one-launch composite forward against the three-launch
  path, and counts the kernel launches of each; the line says
  ``"correct": true`` only after every check passed, and a failed check
  raises before any line is printed.
* ``flops_per_step`` is counted from the shapes (XLA's ``cost_analysis``
  has no counterpart), and the MFU denominator is the card's float32 peak
  on the CUDA cores (``mfu_peak_tflops_f32``), which the exact-f32 kernels
  run on; ``bench.py``'s ``mfu_peak_tflops_bf16`` names another quantity.
* ``bench.py``'s ``_flagship_trace_fields`` is not ported: it sums the wall
  time of the JAX package's TPU training logs under ``runs/plate_analytic/``,
  which are TPU numbers, not the port's.  Nor is its ``_CPU_IDLE_REFERENCE``,
  a JAX XLA-CPU rate of another host: ``host_busy`` comes from the 1-minute
  load average alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .cases import plate_hole
from .cases.base import Case, _phase_loss_fn, run_pipeline
from .device import resolve_device
from .kernels import fused_jet as fj
from .kernels import fused_jet_vjp as fv
from .losses.terms import PDEResidual, Traction
from .models.fields import CompositeFieldModel
from .train.lbfgs import minimize
from .train.step import make_loss_fn, value_and_grad
from .utils.profiling import (F32_PEAK_FLOPS, bwd_flops_per_point,
                              time_blocked)
from .utils.tree import tree_leaves, tree_map

PAD = 8             # pad_to_multiple_of of every bank, as bench.py builds them
FWD_POINTS = 131_072
FWD_ITERS = 20
UV_ITERS = 10
WINDOWS = 3         # timed windows; the best one counts
# Tolerances of the correctness check (chip_smoke.py's): the loss relative
# to eager float64, gradients and forward streams scaled by max(1, max|ref|).
TOL_LOSS = 1e-5
TOL_GRAD = 2e-4
TOL_FWD = 1e-5
BUSY_LOAD = 0.5     # 1-minute load average above which the host is busy
# Float32 peak on the CUDA cores by card name (torch.cuda.get_device_name):
# the SXM H100 reports "NVIDIA H100 80GB HBM3".  Other cards give None, as
# bench.py gives None for an unknown TPU.
PEAK_TFLOPS_F32 = {"H100 80GB HBM3": F32_PEAK_FLOPS / 1e12}
NETS = ("uv", "dist", "part")


# -- timing -----------------------------------------------------------------

def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_seconds(fn: Callable, iters: int, windows: int = WINDOWS) -> float:
    """Seconds per call of ``fn``: one untimed call (it builds the kernels
    and fills the allocator), then the best of ``windows`` windows of
    ``iters`` calls (``time_blocked``: each result waited for on the
    device, as ``bench.py`` blocks on every result; host clock)."""
    return min(time_blocked(fn, iters=iters, warmup=int(w == 0))
               for w in range(windows))


def _median_seconds(fn: Callable, device: torch.device, runs: int,
                    warmup: int = 3) -> float:
    """Median seconds of one call of ``fn``: CUDA events around each call on
    the card (``chip_smoke.py::time_cuda``), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(1e-3 * start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


# -- the measured configuration ---------------------------------------------

def build(scale: float, *, jet_impl: str = "auto", device="cuda"):
    """(case, scalar_loss, params, n_col): the net-BC plate at ``scale``
    with every bank padded to a multiple of 8, ``scalar_loss(params,
    banks)`` the main loss over the whole parameter tree, parameters from
    seed 0, and the count of real collocation points (103,711 at scale
    1.0)."""
    case = plate_hole.build(scale=scale, pad_to_multiple_of=PAD,
                            jet_impl=jet_impl, device=device)
    loss_fn = make_loss_fn(case.model, case.loss, case.material)

    def scalar_loss(params, banks):
        total, _ = loss_fn(params, banks)
        return total

    params = case.init_params(seed=0)
    n_col = int(case.banks["collocation"].mask.sum())
    return case, scalar_loss, params, n_col


def flops_per_step(case: Case) -> float:
    """FLOPs of one value+grad of the net-BC case's main loss, counted from
    the shapes: for each (bank, term) of the loss, the bank's rows (padding
    included, as the kernels compute them) times the streams its jet
    carries (the residual's jet: value, one tangent per input and, at order
    2, ∂²/∂t², five on the plate's collocation bank; the traction's plain
    forward: the value alone) times the per-point FLOPs of one value+grad
    through each of the three nets (``bwd_flops_per_point``: 6·S per weight
    of a hidden layer, 4·S per weight of the head).  Elementwise work
    (tanh, the residuals, the squares and sums) adds nothing."""
    model = case.model
    if not isinstance(model, CompositeFieldModel) or model.uv_fourier:
        raise ValueError(f"no FLOP count for {type(model).__name__}")
    spec = model.spec
    total = 0
    for bank_name, term in case.loss.terms:
        if isinstance(term, PDEResidual):
            streams = 1 + spec.n_inputs + (spec.jet_order >= 2)
        elif isinstance(term, Traction) and term.net is None:
            streams = 1
        else:
            raise ValueError(f"no FLOP count for {type(term).__name__}")
        per_point = sum(bwd_flops_per_point(getattr(model, f"{k}_net").layers,
                                            streams) for k in NETS)
        total += case.banks[bank_name].n_total * per_point
    return float(total)


def peak_tflops(device) -> Optional[float]:
    """The MFU denominator: the card's float32 peak in TFLOP/s, or None for
    a card not in ``PEAK_TFLOPS_F32`` and for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_TFLOPS_F32.items():
        if key in name:
            return peak
    return None


def device_identity(device) -> dict:
    """What the numbers ran on: the card's name, the count of cards, its
    power limit as ``nvidia-smi`` reads it, and the torch and CUDA versions;
    ``{"type": "cpu", ...}`` on the CPU."""
    device = torch.device(device)
    ident = {"type": device.type, "torch": torch.__version__,
             "cuda": torch.version.cuda}
    if device.type != "cuda":
        return {**ident, "name": "cpu", "count": 1, "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    line = smi.stdout.strip().splitlines()[0]
    return {**ident, "name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "power_limit": line.rsplit(",", 1)[-1].strip()}


# -- the correctness check --------------------------------------------------

def _eager_f64(case: Case) -> Case:
    """The same case with float64 banks and the eager jet."""
    banks = {k: dataclasses.replace(
        b, xyt=b.xyt.double(), mask=b.mask.double(),
        values={v: t.double() for v, t in b.values.items()})
        for k, b in case.banks.items()}
    return dataclasses.replace(
        case, model=dataclasses.replace(case.model, jet_impl="eager"),
        banks=banks)


def _composite_paths(model, params, x):
    """(one, three): the order-2 composite jet part + dist·uv as one B4
    launch and as three B1 launches combined by the product rule, each
    returning the full (S, N, C) stream stack."""
    kw = dict(lb=model.lb, ub=model.ub) if model.normalize else {}
    a = x.shape[1]

    def one():
        return fj.fused_composite_jet_stack(params, x, order=2, **kw)

    def three():
        uv, dist, part = (
            fj.jet_from_stack(fj.fused_jet_stack(params[k], x, order=2, **kw),
                              a, 2) for k in NETS)
        return fj.stack_jet(part + dist * uv)

    return one, three


def _forward_points(n: int, device) -> torch.Tensor:
    """(n, 3) float32 points in [0, 0.5)^3 from a numpy seed."""
    x = np.random.default_rng(1).uniform(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(x * np.float32(0.5), device=device)


def _counted(fn: Callable):
    """(result, launches): one call of ``fn`` and the kernel launches it
    made (the wrappers count only on a CUDA tensor)."""
    fj.reset_launches()
    fv.reset_launches()
    out = fn()
    return out, {**fj.LAUNCHES, **fv.LAUNCHES}


def _scaled(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))


def expected_launches(device) -> Dict[str, Dict[str, int]]:
    """Kernel launches of each checked call: on the card one B4 forward and
    one B5 backward per value+grad (the collocation bank's jet; the hole
    bank's traction needs only the plain forward), one B4 for the
    one-launch forward and three B1 for the three-launch path; none on the
    CPU, whose plain versions count nothing."""
    vg = {"fused_composite_jet": 1, "fused_composite_jet_bwd": 1}
    per_call = {"full_value_and_grad": vg, "uv_phase_value_and_grad": vg,
                "one_launch_forward": {"fused_composite_jet": 1},
                "three_launch_forward": {"fused_mlp_jet": 3}}
    card = torch.device(device).type == "cuda"
    zero = dict.fromkeys([*fj.LAUNCHES, *fv.LAUNCHES], 0)
    return {k: {**zero, **(v if card else {})} for k, v in per_call.items()}


def check_outputs(case: Case, scalar_loss, params,
                  n: int = FWD_POINTS) -> dict:
    """Hold the bench's paths before timing them: the first full-loss and
    uv-phase value+grads against the same functions on the eager float64
    route on the same device (loss within 1e-5 relative, every gradient
    within 2e-4·max(1, max|ref|)), the one-launch composite forward against
    the three-launch path at ``n`` points (1e-5·max(1, max|ref|)), and the
    kernel launches of each call against :func:`expected_launches`.
    Returns the errors and launches; raises ``AssertionError`` on any
    miss."""
    device = _device_of(params)
    case64 = _eager_f64(case)
    params64 = tree_map(lambda t: t.double(), params)
    banks = case.banks
    phase = case.phases[-1]
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    sub_fn64, sub64, _ = _phase_loss_fn(case64, phase, params64)
    loss64_fn = make_loss_fn(case64.model, case64.loss, case64.material)
    pairs = {
        "full_value_and_grad": (
            lambda: value_and_grad(lambda p: scalar_loss(p, banks), params),
            lambda: value_and_grad(
                lambda p: loss64_fn(p, case64.banks)[0], params64)),
        "uv_phase_value_and_grad": (lambda: value_and_grad(sub_fn, sub0),
                                    lambda: value_and_grad(sub_fn64, sub64)),
    }
    errors, launches = {}, {}
    for name, (kernel_vg, f64_vg) in pairs.items():
        (loss, grads), launches[name] = _counted(kernel_vg)
        loss64, grads64 = f64_vg()
        rel = abs(float(loss) - float(loss64)) / abs(float(loss64))
        g_err = max(_scaled(g, r) for g, r in
                    zip(tree_leaves(grads), tree_leaves(grads64)))
        errors[name] = {"loss_rel": rel, "grad_scaled": g_err}
        if not (rel <= TOL_LOSS and g_err <= TOL_GRAD):
            raise AssertionError(
                f"{name}: loss {float(loss)!r} against float64 "
                f"{float(loss64)!r} (relative {rel:.3e}, limit {TOL_LOSS}), "
                f"gradients {g_err:.3e} scaled (limit {TOL_GRAD})")
    one, three = _composite_paths(case.model, params,
                                  _forward_points(n, device))
    with torch.no_grad():
        got, launches["one_launch_forward"] = _counted(one)
        ref, launches["three_launch_forward"] = _counted(three)
    fwd_err = _scaled(got, ref.double())
    errors["one_launch_forward"] = {"scaled": fwd_err}
    if not fwd_err <= TOL_FWD:
        raise AssertionError(f"one-launch composite forward against the "
                             f"three-launch path: {fwd_err:.3e} scaled "
                             f"(limit {TOL_FWD})")
    want = expected_launches(device)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    _sync(device)
    return {"errors": errors, "launches": launches}


# -- the measurements -------------------------------------------------------

def rate_blocked(scalar_loss, params, banks, n_col: int, iters: int,
                 windows: int = WINDOWS):
    """(collocation evals/s, seconds per value+grad) of the full loss."""
    step = _best_seconds(
        lambda: value_and_grad(lambda p: scalar_loss(p, banks), params),
        iters, windows)
    return n_col / step, step


def uv_phase_rate(case: Case, params, n_col: int, iters: int = UV_ITERS):
    """Collocation evals/s of the uv-phase value+grad, dist and part frozen:
    the evaluation L-BFGS repeats in the main phase."""
    sub_fn, sub0, _ = _phase_loss_fn(case, case.phases[-1], params)
    return n_col / _best_seconds(lambda: value_and_grad(sub_fn, sub0),
                                 iters)


def composite_forward_rate(case: Case, params, iters: int = FWD_ITERS,
                           n: int = FWD_POINTS):
    """(one-launch evals/s, three-launch time / one-launch time) of the
    order-2 composite forward (value, tangents and ∂²/∂t² of all fields)
    at ``n`` points: one B4 launch against three B1 launches and the
    product-rule combine, medians of ``iters`` calls."""
    device = _device_of(params)
    one, three = _composite_paths(case.model, params,
                                  _forward_points(n, device))
    with torch.no_grad():
        t_one = _median_seconds(one, device, iters)
        t_three = _median_seconds(three, device, iters)
    return n / t_one, t_three / t_one


def lbfgs_iter_rate(case: Case, params, iters: int):
    """(carried iterations/s, carried iterations, cold iterations/s) of
    L-BFGS on the main loss over the whole tree.  A 50-iteration run warms
    up; the cold rate is a fresh 100-iteration run, whose line searches try
    many steps while the curvature memory fills; the carried rate continues
    from its carry with ``ftol=0``, the regime of long runs."""
    device = _device_of(params)
    loss = case.loss_fn(case.phases[-1].loss)
    minimize(loss, params, maxiter=50, segment=50, patience=200)
    _sync(device)
    t0 = time.perf_counter()
    warm = minimize(loss, params, maxiter=100, segment=50, patience=200)
    _sync(device)
    cold_rate = warm.n_iters / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    res = minimize(loss, params, maxiter=iters, segment=min(50, iters),
                   ftol=0.0, init_carry=warm.carry, patience=200)
    _sync(device)
    rate = res.n_iters / (time.perf_counter() - t0)
    return rate, res.n_iters, cold_rate


def cpu_rate(scale: float, iters: int) -> float:
    """Collocation evals/s, per point, of the same full-loss value+grad on
    the CPU (eager jet) at ``scale``: one untimed call, then one window of
    ``iters`` calls."""
    case, scalar_loss, params, n_col = build(scale, jet_impl="eager",
                                             device="cpu")
    rate, _ = rate_blocked(scalar_loss, params, case.banks, n_col, iters,
                           windows=1)
    return rate


def seconds_to_target(scale: float, threshold: float, maxiter: int, *,
                      seed: int = 0, repeats: int = 3,
                      pretrain_iters: int = 300, with_cpu: bool = True,
                      device="cuda", dtype=torch.float32, params=None) -> dict:
    """Wall seconds of the from-scratch plate uv phase to reach a loss of
    ``threshold`` (BASELINE.md metric #1 at bench timescales).

    The net-BC plate at ``scale`` (padded to 8) from ``params`` (default:
    ``init_params(seed)``) runs ``run_pipeline`` with ``pretrain_iters``
    L-BFGS iterations of dist and of part and none of uv (segments of 50);
    a 10-iteration uv-phase run warms up; then ``repeats`` timed uv-phase
    runs of at most ``maxiter`` iterations (segments of 10) stop at the
    threshold.  The trajectory from the same start is the same each time,
    so the median wall and its [min, max] are timing noise alone.

    With ``with_cpu`` the CPU figure is the device wall times the ratio of
    one uv-phase value+grad on the CPU (eager jet, the same banks) to one on
    the device, both from the post-pretrain state: the CPU would need the
    same evaluations.
    """
    device = resolve_device(device)
    case = plate_hole.build(scale=scale, pad_to_multiple_of=PAD,
                            dtype=dtype, device=device)
    if params is None:
        params = case.init_params(seed=seed, dtype=dtype)
    params, _ = run_pipeline(
        case, params, dtype=dtype,
        maxiter_override={"dist": pretrain_iters, "part": pretrain_iters,
                          "uv": 0},
        segment=50)
    phase = case.phases[-1]
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    minimize(sub_fn, sub0, maxiter=10, segment=10)
    walls, res = [], None
    for _ in range(max(1, repeats)):
        _sync(device)
        t0 = time.perf_counter()
        res = minimize(sub_fn, sub0, maxiter=maxiter, segment=10,
                       target=threshold)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    final = float(res.final_loss)
    out = {
        "seconds_to_target": wall,
        "seconds_to_target_spread": [min(walls), max(walls)],
        "target_loss": threshold,
        "target_iters": int(res.n_iters),
        "target_hit": bool(final <= threshold),
        "target_final_loss": final,
        "target_scale": scale,
        "seconds_to_target_cpu": None,
        "speedup_to_target": None,
    }
    if not with_cpu:
        return out

    def per_eval(fn, p0, reps):
        return _best_seconds(lambda: value_and_grad(fn, p0), reps)

    dev_eval = per_eval(sub_fn, sub0, 6)
    case_c = plate_hole.build(scale=scale, pad_to_multiple_of=PAD,
                              dtype=dtype, jet_impl="eager", device="cpu")
    sub_fn_c, sub0_c, _ = _phase_loss_fn(
        case_c, case_c.phases[-1], tree_map(lambda t: t.cpu(), params))
    ratio = per_eval(sub_fn_c, sub0_c, 3) / dev_eval
    out.update(seconds_to_target_cpu=wall * ratio, speedup_to_target=ratio)
    return out


STT_KEYS = ("seconds_to_target", "seconds_to_target_spread", "target_loss",
            "target_iters", "target_hit", "target_final_loss", "target_scale",
            "seconds_to_target_cpu", "speedup_to_target")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pinn_elastodynamics_torch.bench",
        description="Time the flagship plate's value+grad, L-BFGS and "
                    "seconds-to-target; print one JSON line.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--blocked-iters", type=int, default=10)
    ap.add_argument("--lbfgs-iters", type=int, default=100)
    ap.add_argument("--cpu-scale", type=float, default=1 / 16)
    ap.add_argument("--cpu-iters", type=int, default=2)
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--skip-lbfgs", action="store_true")
    ap.add_argument("--skip-stt", action="store_true",
                    help="skip the seconds-to-target measurement")
    # bench.py's proxy threshold, calibrated on the JAX package's seed-0
    # draw at scale 0.1 (uv loss about 57 at the start, 10.0 crossed near
    # iteration 245).  The port draws from a torch.Generator, so its
    # trajectory is another; target_hit says whether it crossed.
    ap.add_argument("--stt-scale", type=float, default=0.1)
    ap.add_argument("--stt-threshold", type=float, default=10.0)
    ap.add_argument("--stt-maxiter", type=int, default=600)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench and print its one JSON line; returns the line's
    object.  Raises without a card unless ``--device cpu``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host_load_start = os.getloadavg()[0]

    case, scalar_loss, params, n_col = build(args.scale, device=device)
    banks = case.banks
    checked = check_outputs(case, scalar_loss, params, n=FWD_POINTS)
    fj.reset_launches()
    fv.reset_launches()

    rate, step_s = rate_blocked(scalar_loss, params, banks, n_col,
                                args.blocked_iters)
    flops_step = flops_per_step(case)
    peak = peak_tflops(device)
    tflops = flops_step / step_s / 1e12
    mfu = tflops / peak if peak else None
    uv_rate = uv_phase_rate(case, params, n_col)
    comp_rate, comp_speedup = composite_forward_rate(case, params,
                                                     n=FWD_POINTS)
    lbfgs_rate = lbfgs_iters = lbfgs_cold = None
    if not args.skip_lbfgs:
        lbfgs_rate, lbfgs_iters, lbfgs_cold = lbfgs_iter_rate(
            case, params, args.lbfgs_iters)
    cpu = None
    if not args.skip_cpu:
        cpu = cpu_rate(args.scale * args.cpu_scale, args.cpu_iters)
    stt = dict.fromkeys(STT_KEYS)
    if not args.skip_stt:
        stt = seconds_to_target(args.stt_scale, args.stt_threshold,
                                args.stt_maxiter, with_cpu=not args.skip_cpu,
                                device=device)
    total = {**fj.LAUNCHES, **fv.LAUNCHES}

    line = {
        "metric": "collocation_evals_per_sec",
        "value": rate,
        "unit": "evals/s",
        "vs_baseline": rate / cpu if cpu else None,
        "device": device_identity(device),
        "correct": True,
        "n_collocation": n_col,
        "step_seconds": step_s,
        "flops_per_step": flops_step,
        "flops_per_eval": flops_step / n_col,
        "tflops_sustained": tflops,
        "mfu": mfu,
        "mfu_peak_tflops_f32": peak,
        "uv_phase_evals_per_sec": uv_rate,
        "composite_fwd_evals_per_sec": comp_rate,
        "composite_fused_speedup": comp_speedup,
        "lbfgs_iters_per_sec": lbfgs_rate,
        "lbfgs_iters_per_sec_cold": lbfgs_cold,
        "lbfgs_iters_measured": lbfgs_iters,
        "cpu_evals_per_sec": cpu,
        "host_load_start": host_load_start,
        "host_busy": host_load_start > BUSY_LOAD,
        "check": checked["errors"],
        "launches": {**checked["launches"], "measurements": total},
        **stt,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
