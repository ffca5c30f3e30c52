"""Full-batch L-BFGS with a zoom line search (PyTorch).

Counterpart of ``pinn_elastodynamics_tpu/train/lbfgs.py``, which runs
``optax.lbfgs(memory_size=50)`` with ``scale_by_zoom_linesearch(
max_linesearch_steps=50, initial_guess_strategy="one")`` in jitted
segments.  Here the same algorithm is written out:

* the two-loop preconditioner of ``optax.scale_by_lbfgs`` (ring-buffer
  memory of parameter and gradient differences, ρ weights, γ scaling of the
  identity; the first step's γ is the capped reciprocal of the gradient
  norm);
* optax's ``zoom_linesearch``: interval search, then zoom by cubic,
  quadratic or bisection steps, with the sufficient-decrease criterion
  relaxed to Hager and Zhang's approximate Wolfe condition near a minimum,
  the curvature criterion, and the safe-step fallback;
* the ``minimize`` loop with the ftol stop and its patience, the gtol,
  non-finite and ``target`` stops, segments with a host hook between them,
  and a carry that resumes a run with its curvature history.

The trainable tree is held as one flat vector, the curvature memory as
``(m, P)`` tensors on its device and in its dtype; line-search scalars are
0-d tensors there too.  The host reads only what decides control flow: one
read of the line search's branch and stop flags per trial step and one of
the iteration's ``done`` flag.  The value and gradient at the accepted
point are reused by the next iteration, so an iteration costs exactly as
many value+grads as its line search tries; a fresh run also reuses its seed
evaluation for the first iteration (the JAX loop evaluates there again).
While a profiler records, spans (``utils/profiling.py::span``) mark each
call, iteration, direction, line-search trial and host read.
"""

from __future__ import annotations

import inspect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import span
from ..utils.tree import tree_leaves, tree_map
from .step import value_and_grad

# optax.scale_by_zoom_linesearch defaults, as the JAX package leaves them.
TOL = 0.0
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5


class LBFGSResult(NamedTuple):
    params: object
    final_loss: torch.Tensor
    n_iters: int
    loss_history: np.ndarray  # (n_iters,)
    # (params, opt_state, f_prev, flat, done): plain dicts and tensors.
    # ``save_checkpoint`` stores it; pass it back as ``init_carry``.
    carry: object = None


class _Flat:
    """One flat vector for a parameter tree, and the tree back as views."""

    def __init__(self, tree):
        self.template = tree
        self.sizes = [t.numel() for t in tree_leaves(tree)]

    def flatten(self, tree) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    def unflatten(self, x: torch.Tensor):
        pieces = iter(x.split(self.sizes))
        return tree_map(lambda t: next(pieces).view(t.shape), self.template)


# ---------------------------------------------------------------------------
# optax.scale_by_lbfgs
# ---------------------------------------------------------------------------

def _lbfgs_init(x: torch.Tensor, memory_size: int) -> dict:
    zeros = torch.zeros_like(x)
    return {
        "count": 0,
        "params": zeros,
        "updates": zeros,
        "diff_params_memory": x.new_zeros((memory_size, x.numel())),
        "diff_updates_memory": x.new_zeros((memory_size, x.numel())),
        "weights_memory": x.new_zeros((memory_size,)),
    }


def _lbfgs_direction(g: torch.Tensor, state: dict, x: torch.Tensor):
    """``scale_by_lbfgs`` update: store the newest (Δx, Δg) pair, then the
    two-loop product of the inverse-Hessian estimate with ``g``."""
    count = state["count"]
    dw_mem, du_mem = state["diff_params_memory"], state["diff_updates_memory"]
    rhos = state["weights_memory"]
    m = rhos.shape[0]
    mem_idx, prev_idx = count % m, (count - 1) % m
    if count > 0:
        dw = x - state["params"]
        du = g - state["updates"]
        vdot = torch.dot(du, dw)
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        slot = torch.tensor([prev_idx], device=x.device)
        dw_mem = dw_mem.index_copy(0, slot, dw[None])
        du_mem = du_mem.index_copy(0, slot, du[None])
        rhos = rhos.index_copy(0, slot, weight[None])
        denominator = torch.dot(du, du)
        gamma = torch.where(denominator > 0.0, vdot / denominator, 1.0)
    else:
        # Slot m-1 receives zeros at the first step, as in optax.
        gamma = torch.clamp(1.0 / torch.sqrt(torch.dot(g, g)), max=1.0)

    # Two-loop recursion, oldest pair last in the first loop.  A slot never
    # written holds zeros and changes nothing, so it is skipped.
    indices = [(mem_idx + i) % m for i in range(m)][m - min(count, m):]
    vec, alphas = g, {}
    for idx in reversed(indices):
        alpha = rhos[idx] * torch.dot(dw_mem[idx], vec)
        vec = vec + (-alpha) * du_mem[idx]
        alphas[idx] = alpha
    vec = gamma * vec
    for idx in indices:
        beta = rhos[idx] * torch.dot(du_mem[idx], vec)
        vec = vec + (alphas[idx] - beta) * dw_mem[idx]

    new_state = {
        "count": count + 1,
        "params": x,
        "updates": g,
        "diff_params_memory": dw_mem,
        "diff_updates_memory": du_mem,
        "weights_memory": rhos,
    }
    return vec, new_state


# ---------------------------------------------------------------------------
# optax.zoom_linesearch
# ---------------------------------------------------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * (dc * dc))) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo error, or the smaller approximate-Wolfe error near a minimum
    (Hager and Zhang, eq. 23 with 26-27 on one iterate); NaN becomes inf."""
    error = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    error = torch.minimum(torch.maximum(approx, delta), error)
    error = torch.clamp(error, min=0.0)
    return torch.where(torch.isnan(error), torch.inf, error)


def _curvature_error(slope, slope_init):
    error = torch.clamp(torch.abs(slope) - CURV_RTOL * torch.abs(slope_init),
                        min=0.0)
    return torch.where(torch.isnan(error), torch.inf, error)


def _where(cond, a: list, b: list) -> list:
    return [torch.where(cond, x, y) for x, y in zip(a, b)]


class _LineSearch:
    """One zoom line search along ``u`` from ``x`` (optax's
    ``ZoomLinesearchState`` as attributes)."""

    def __init__(self, vg: Callable, x, u, value, grad, max_steps: int):
        self.vg, self.x, self.u, self.max_steps = vg, x, u, max_steps
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        slope = torch.dot(u, grad)
        self.count = 0
        self.stepsize, self.value, self.grad = zero, value, grad
        self.slope = slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = zero + torch.inf
        self.interval_found = False
        self.low, self.value_low, self.slope_low = zero, value, slope
        self.high, self.value_high, self.slope_high = zero, value, slope
        self.cubic_ref, self.value_cubic_ref = zero, value
        self.safe_stepsize, self.safe_value = zero, value
        self.safe_grad = grad

    def _probe(self, stepsize):
        """Value, gradient, slope and both errors at ``x + stepsize·u``."""
        value, grad = self.vg(self.x + stepsize * self.u)
        slope = torch.dot(grad, self.u)
        dec = _decrease_error(stepsize, value, slope, self.value_init,
                              self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        return value, grad, slope, dec, curv

    def _search_interval(self):
        """Algorithm 3.5 of Nocedal and Wright: grow the step until an
        interval holding an acceptable step is found."""
        prev = [self.stepsize, self.value, self.slope]
        if self.count == 0:
            new_stepsize = torch.ones_like(self.stepsize)   # strategy "one"
        else:
            new_stepsize = INCREASE_FACTOR * self.stepsize
        value, grad, slope, dec, curv = self._probe(new_stepsize)
        error = torch.maximum(dec, curv)
        self.safe_stepsize, self.safe_value, self.safe_grad = _where(
            dec <= TOL, [new_stepsize, value, grad],
            [self.safe_stepsize, self.safe_value, self.safe_grad])
        set_high_to_new = dec > 0.0
        if self.count > 0:
            set_high_to_new = set_high_to_new | (value >= prev[1])
        set_low_to_new = (slope >= 0.0) & ~set_high_to_new
        new = [new_stepsize, value, slope]
        (self.low, self.value_low, self.slope_low, self.high,
         self.value_high, self.slope_high) = _where(
            set_low_to_new, new + prev, prev + new)
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        done = error <= TOL
        found = set_high_to_new | set_low_to_new | done
        if self.count + 1 >= self.max_steps:
            failed = ~done
        else:
            failed = torch.zeros_like(done)
        self.stepsize, self.value, self.grad = new_stepsize, value, grad
        self.slope = slope
        self.decrease_error, self.curvature_error = dec, curv
        return found, done, failed

    def _zoom_into_interval(self):
        """Algorithm 3.6 of Nocedal and Wright: shrink [low, high] by
        cubic, quadratic or bisection steps."""
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = (self.high, self.value_high,
                                        self.slope_high)
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small_int = delta <= INTERVAL_THRESHOLD

        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 self.cubic_ref, self.value_cubic_ref)
        use_cubic = ((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = (~use_cubic & (middle_quad > left + quad_chk)
                    & (middle_quad < right - quad_chk))
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, middle_cubic, self.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)

        value, grad, slope, dec, curv = self._probe(middle)
        error = torch.maximum(dec, curv)
        update_safe = (dec <= TOL) & (value < self.safe_value)
        self.safe_stepsize, self.safe_value, self.safe_grad = _where(
            update_safe, [middle, value, grad],
            [self.safe_stepsize, self.safe_value, self.safe_grad])
        done = error <= TOL

        set_high_to_middle = (dec > 0.0) | (value >= value_low)
        secant_interval = slope * (high - low)
        set_high_to_low = (secant_interval >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle
        new_high = _where(set_high_to_middle, [middle, value, slope],
                          [high, value_high, slope_high])
        (self.high, self.value_high, self.slope_high) = _where(
            set_high_to_low, [low, value_low, slope_low], new_high)
        (self.low, self.value_low, self.slope_low) = _where(
            set_low_to_middle, [middle, value, slope],
            [low, value_low, slope_low])
        self.cubic_ref, self.value_cubic_ref = _where(
            set_high_to_middle | set_high_to_low, [high, value_high],
            [low, value_low])

        # Stop once the interval is below the threshold and a step with
        # sufficient decrease is known, or at the last step.
        if self.count + 1 >= self.max_steps:
            failed = ~done
        else:
            failed = too_small_int & (self.safe_stepsize > 0.0) & ~done
        self.stepsize, self.value, self.grad = middle, value, grad
        self.slope = slope
        self.decrease_error, self.curvature_error = dec, curv
        return torch.ones_like(done), done, failed

    def _try_safe_step(self):
        """After a failure, fall back to the best step with sufficient
        decrease, if any (or if the last step left the domain)."""
        outside_domain = torch.isinf(self.decrease_error)
        use_safe = (self.safe_stepsize > 0.0) | outside_domain
        self.stepsize, self.value, self.grad = _where(
            use_safe, [self.safe_stepsize, self.safe_value, self.safe_grad],
            [self.stepsize, self.value, self.grad])

    def run(self) -> int:
        """Step until done or failed; returns the number of evaluations.
        The host reads the three flags once per step."""
        while True:
            with span("lbfgs.trial"):
                step = (self._zoom_into_interval if self.interval_found
                        else self._search_interval)
                flags = torch.stack(step())
                with span("lbfgs.read"):
                    found, done, failed = flags.tolist()
                self.count += 1
                self.interval_found = found
                if failed:
                    self._try_safe_step()
            if done or failed:
                return self.count


# ---------------------------------------------------------------------------
# minimize
# ---------------------------------------------------------------------------

def _init_opt_state(x, f0, g0, memory_size: int) -> dict:
    state = _lbfgs_init(x, memory_size)
    state.update({
        "learning_rate": torch.ones((), dtype=x.dtype, device=x.device),
        "value": f0,
        "grad": g0,
        "num_linesearch_steps": 0,
        "decrease_error": torch.full((), torch.inf, dtype=x.dtype,
                                     device=x.device),
        "curvature_error": torch.full((), torch.inf, dtype=x.dtype,
                                      device=x.device),
    })
    return state


def _lbfgs_step(vg: Callable, x, state: dict, max_linesearch_steps: int):
    """One ``optax.lbfgs`` update: direction, zoom line search, step.
    Returns the new point and state; the state holds the accepted point's
    value and gradient."""
    f, g = state["value"], state["grad"]
    pairs = min(state["count"], state["weights_memory"].shape[0])
    with span("lbfgs.direction", pairs=pairs):
        direction, lbfgs_state = _lbfgs_direction(g, state, x)
    u = -1.0 * direction
    ls = _LineSearch(vg, x, u, f, g, max_linesearch_steps)
    n_steps = ls.run()
    x_new = x + ls.stepsize * u
    new_state = dict(lbfgs_state)
    new_state.update({
        "learning_rate": ls.stepsize,
        "value": ls.value,
        "grad": ls.grad,
        "num_linesearch_steps": n_steps,
        "decrease_error": ls.decrease_error,
        "curvature_error": ls.curvature_error,
    })
    return x_new, new_state


def minimize(
    loss_fn: Callable,
    params,
    *,
    maxiter: int,
    memory_size: int = 50,
    max_linesearch_steps: int = 50,
    ftol: float = 0.0,
    gtol: float = 0.0,
    log_every: int = 0,
    patience: int = 5,
    segment: int = 100,
    on_segment: Optional[Callable] = None,
    init_carry=None,
    target: float = -np.inf,
) -> LBFGSResult:
    """Minimize ``loss_fn(params) -> scalar`` over a tree of tensors.

    Stops after ``maxiter`` iterations (in whole segments, as the JAX loop
    does), or once the loss decreased by at most ``ftol·max(|f_k|,
    |f_{k+1}|, 1)`` on ``patience`` consecutive iterations, the gradient's
    ∞-norm is at most ``gtol``, the loss is not finite, or it reaches
    ``target``.

    ``on_segment(k_total, params, segment_history)`` runs between segments
    of ``segment`` iterations; a callback that also accepts a ``carry``
    keyword receives the optimizer carry, which ``save_checkpoint`` stores.
    ``init_carry`` resumes from such a carry (same ``memory_size``): the
    curvature memory and the last value and gradient carry over, and the
    stop flags and the patience counter start afresh.
    """
    with span("lbfgs.minimize"):
        seg_len = min(segment, max(1, maxiter))
        if init_carry is not None:
            params, opt_state, f0, _flat, _done = init_carry
            layout = _Flat(params)
            x = layout.flatten(params)
            # A non-finite carried value is evaluated again, as optax's
            # value_and_grad_from_state does.
            with span("lbfgs.read"):
                finite = bool(torch.isfinite(opt_state["value"]))
            if not finite:
                value, grad = value_and_grad(loss_fn, params)
                opt_state = dict(opt_state, value=value,
                                 grad=layout.flatten(grad))
        else:
            layout = _Flat(params)
            x = layout.flatten(params)
            f0, g0 = value_and_grad(loss_fn, params)
            opt_state = _init_opt_state(x, f0, layout.flatten(g0), memory_size)
        flat = torch.zeros((), dtype=torch.int32, device=x.device)
        done = torch.zeros((), dtype=torch.bool, device=x.device)
        f_prev = torch.as_tensor(f0, device=x.device)

        def vg(point):
            value, grad = value_and_grad(loss_fn, layout.unflatten(point))
            return value, layout.flatten(grad)

        pass_carry = on_segment is not None and (
            "carry" in inspect.signature(on_segment).parameters)
        histories = []
        k_total = k_logged = 0
        stopped = False
        carry = (layout.unflatten(x), opt_state, f_prev, flat, done)
        while k_total < maxiter:
            hist = []
            while len(hist) < seg_len and not stopped:
                with span("lbfgs.iteration"):
                    x, opt_state = _lbfgs_step(vg, x, opt_state,
                                               max_linesearch_steps)
                    f_new, g_new = opt_state["value"], opt_state["grad"]
                    hist.append(f_new)
                    denom = torch.clamp(
                        torch.maximum(torch.abs(f_prev), torch.abs(f_new)),
                        min=1.0)
                    ftol_hit = (f_prev - f_new) <= ftol * denom
                    flat = torch.where(ftol_hit, flat + 1, 0).to(torch.int32)
                    gtol_hit = torch.max(torch.abs(g_new)) <= gtol
                    done = ((flat >= patience) | gtol_hit
                            | ~torch.isfinite(f_new) | (f_new <= target))
                    f_prev = f_new
                    with span("lbfgs.read"):
                        stopped = bool(done)
            k_seg = len(hist)
            with span("lbfgs.read"):
                hist = torch.stack(hist).cpu().numpy() if hist else np.zeros(
                    (0,), np.float32)
            histories.append(hist)
            k_total += k_seg
            carry = (layout.unflatten(x), opt_state, f_prev, flat, done)
            if log_every and len(hist) and k_total - k_logged >= log_every:
                k_logged = k_total
                print(f"lbfgs it {k_total}: loss {hist[-1]:.6e}", flush=True)
            if on_segment is not None:
                if pass_carry:
                    on_segment(k_total, carry[0], hist, carry=carry)
                else:
                    on_segment(k_total, carry[0], hist)
            if stopped or k_seg < seg_len:
                break

        history = (np.concatenate(histories) if histories
                   else np.zeros((0,), np.float32))
        return LBFGSResult(params=carry[0], final_loss=carry[2],
                           n_iters=k_total, loss_history=history, carry=carry)
