"""Host-precision L-BFGS: float64 optimizer math on the host, float32
value+grads on the device.

Counterpart of ``pinn_elastodynamics_tpu/train/lbfgs_host.py``.  Near the
optimum the f32 plate-hole endgame wedges: loss differences and curvature
pairs fall below f32 resolution (docs/STATUS_r2.md), and the reference
escapes by training entirely in f64 on the CPU
(PlateHoleQuarter/train/train.py:115).  Here the device runs one function,
the f32 value+grad of the phase loss through the fused kernels, which also
emits every loss component's per-chunk partial sums
(``banks.ChunkSumCollector``); the host adds those in float64 and runs the
whole optimizer — two-loop recursion, curvature memory, strong-Wolfe zoom
line search, scipy's ftol rule — in numpy float64.  That is the reference's
own host/device split (scipy around TensorFlow, train.py:219-247,508-525),
with noise-aware safeguards (cautious curvature acceptance) because the
gradient itself carries f32 noise.

:func:`minimize_host`, :func:`make_preconditioned_vg` and
:func:`_two_loop` are numpy and a faithful copy of the JAX package's: the
same operations in the same order, so that the histories are bitwise its
histories.  :func:`make_host_phase_vg` (a case phase) and
:func:`make_host_problem_vg` (the inverse problem's joint tree) build the
device half.  Device L-BFGS (train/lbfgs.py) remains the production path
away from the precision floor; this engine takes over for the endgame.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..banks import ChunkSumCollector
from ..utils.tree import tree_leaves, tree_map
from ..utils.treepath import path_get, path_set

# Counts travel to the host as float32, exact for integers below 2**24.
MAX_EXACT_COUNT = 2 ** 24


def make_host_phase_vg(case, phase, params, *, chunk_size: int = 512):
    """Device value+grad for :func:`minimize_host` over one case phase.

    The device function is pure f32 (the kernels at full speed); it
    returns the f32 gradient plus every loss component's per-chunk partial
    sums, packed with the valid-point counts into one device tensor that
    reaches the host in one copy (JAX's one ``jax.device_get``).  The host
    reassembles the float64 loss: mean_k = Σ_chunks(sums)/count in f64,
    total = scale·Σ_k w_k·mean_k.  The loss then resolves to about
    eps32/n_chunks instead of eps32.

    Returns (host_vg, x0_flat64, unravel32): ``host_vg`` maps a float64
    flat vector to (float loss, float64 flat grad); ``x0_flat64`` is the
    phase's trainable subtree flattened in its own dtype, in
    ``jax.flatten_util.ravel_pytree`` order (sorted dict keys, each leaf
    C-order), then widened to float64; ``unravel32`` maps a flat vector to
    that subtree in f32 on the case's device.  ``host_vg.device`` (flat
    f32 tensor -> the packed device tensor) and ``host_vg.host`` (the
    packed array on the host -> (loss, grad)) are its two halves, which
    ``host_vg`` joins with the one ``.cpu()`` copy.
    """
    spec = phase.loss
    key = phase.trainable
    if key is None:
        frozen = None
        sub0 = params
    else:
        # Frozen sub-nets live on the device in f32 (the compute dtype).
        # ``key`` may be a dotted path ("uv.mlp"): the whole tree is frozen
        # in f32 and the trainable subtree spliced in at evaluation.
        frozen = _to32(params)
        sub0 = path_get(params, key)

    def total(sub32, coll):
        p = path_set(frozen, key, sub32) if key is not None else sub32
        loss, _comps = spec.evaluate(case.model, p, case.material,
                                     case.banks, collector=coll)
        return phase.scale * loss

    return _make_host_vg(total, sub0, case.banks, spec.weight_map(),
                         float(phase.scale), chunk_size)


def make_host_problem_vg(problem, banks, params, *, chunk_size: int = 512):
    """Device value+grad for :func:`minimize_host` over a joint problem.

    The scheme of :func:`make_host_phase_vg` for problem objects exposing
    ``loss_and_aux(params, banks, collector=)`` and a ``weights`` tuple —
    the inverse problem (cases/inverse.py), where every leaf (the net and
    the log-material parameters) is trainable.  The f32 polish of that
    problem resolution-floors at a loss of about 4e-3 with rho biased 4.6%
    (JAX package, runs/inverse/recovery.json); the f64 host loss restores
    the line search's ability to certify the small joint-valley decreases.

    Returns (host_vg, x0_flat64, unravel32), as :func:`make_host_phase_vg`
    does; ``x0_flat64`` follows ``ravel_pytree``'s sorted keys: ``log_E``,
    ``log_rho``, then ``net``.
    """

    def total(p32, coll):
        loss, _comps = problem.loss_and_aux(p32, banks, collector=coll)
        return loss

    return _make_host_vg(total, params, banks, dict(problem.weights), 1.0,
                         chunk_size)


def _to32(tree):
    return tree_map(lambda t: t.detach().to(torch.float32), tree)


def _make_host_vg(total, sub0, banks, wmap, scale: float, chunk_size: int):
    """The host value+grad over ``total(sub32, collector)``, a loss of the
    f32 tree shaped like ``sub0`` that feeds every masked square-and-mean
    to the collector; ``wmap`` and ``scale`` rebuild that loss in float64
    from the collector's chunk sums."""
    too_big = {k: b.n_total for k, b in banks.items()
               if b.n_total >= MAX_EXACT_COUNT}
    if too_big:
        raise ValueError(f"banks {too_big} hold 2**24 points or more; their "
                         "counts would not travel exactly as float32")
    # Seed x0 from the parameters' own dtype (f64 checkpoints keep their
    # full precision on the host side), but build the unravel over f32.
    leaves0 = tree_leaves(sub0)
    x0_flat = np.concatenate(
        [t.detach().cpu().numpy().reshape(-1) for t in leaves0]
    ).astype(np.float64)
    sizes = [t.numel() for t in leaves0]
    device = leaves0[0].device

    def unravel32(zflat):
        z = torch.as_tensor(zflat, dtype=torch.float32, device=device)
        parts = iter(torch.split(z, sizes))
        return tree_map(lambda t: next(parts).view(t.shape), sub0)

    names: List[str] = []
    n_chunks: List[int] = []

    def device_vg(z32: torch.Tensor) -> torch.Tensor:
        """[grad; chunk sums of every entry; counts], f32 on the device."""
        z = z32.detach().requires_grad_()
        coll = ChunkSumCollector(chunk_size)
        (g,) = torch.autograd.grad(total(unravel32(z), coll), z)
        names[:] = coll.names
        n_chunks[:] = [a.numel() for a in coll.arrays]
        return torch.cat([g, *(a.detach().to(torch.float32)
                               for a in coll.arrays),
                          torch.stack(coll.counts).detach().to(torch.float32)])

    n = x0_flat.size

    def host_sums(packed: np.ndarray):
        """(float64 loss, float64 grad) from the packed device result."""
        g, off = packed[:n], n
        sums = []
        for k in n_chunks:
            sums.append(packed[off : off + k])
            off += k
        counts = packed[off:]
        comp = {}
        for name, s_arr, c in zip(names, sums, counts):
            comp[name] = comp.get(name, 0.0) + (
                float(np.asarray(s_arr, np.float64).sum()) / float(c)
            )
        loss = scale * sum(wmap.get(k, 0.0) * v for k, v in comp.items())
        return loss, np.asarray(g, np.float64)

    def host_vg(z64: np.ndarray):
        z32 = torch.as_tensor(np.asarray(z64, np.float32), device=device)
        # The one device-to-host copy of the evaluation.
        return host_sums(device_vg(z32).cpu().numpy())

    host_vg.device = device_vg
    host_vg.host = host_sums
    return host_vg, x0_flat, unravel32


def make_preconditioned_vg(host_vg, d: np.ndarray):
    """Diagonal (Jacobi) preconditioning wrapper for :func:`minimize_host`.

    Optimizes in whitened coordinates u = x / d: the wrapped value+grad is
    f̃(u) = f(d∘u) with ∇f̃ = d∘∇f, so L-BFGS's implicit initial Hessian
    I becomes diag(d)² in the original space.  Use a per-block scale (e.g.
    d_block ∝ 1/rms(g_block)) when parameter blocks have mismatched
    gradient/curvature scales — the Fourier frequency matrix B carries ~6×
    the MLP blocks' gradient RMS at the full-scale semi wedge
    (docs/STATUS_r4.md handoff item 3).

    Returns (vg_u, to_u, from_u): the whitened value+grad plus coordinate
    maps.  Minimize with ``minimize_host(vg_u, to_u(x0))`` and map the
    result back with ``from_u(res.x)``; carries are only valid in one
    coordinate system.
    """
    d = np.asarray(d, np.float64)

    def vg_u(u):
        f, g = host_vg(d * u)
        return f, d * g

    return vg_u, (lambda x: np.asarray(x, np.float64) / d), (
        lambda u: d * np.asarray(u, np.float64))


@dataclasses.dataclass
class HostLBFGSResult:
    x: np.ndarray
    final_loss: float
    n_iters: int
    n_evals: int
    loss_history: np.ndarray
    converged: str  # "maxiter" | "ftol" | "gtol" | "target" | "linesearch"
    carry: Optional[dict] = None  # curvature memory for resumption


def _two_loop(g: np.ndarray, S: List[np.ndarray], Y: List[np.ndarray],
              R: List[float]) -> np.ndarray:
    """Standard two-loop recursion with gamma scaling; all float64."""
    q = g.copy()
    alphas = []
    for s, y, rho in zip(reversed(S), reversed(Y), reversed(R)):
        a = rho * s.dot(q)
        alphas.append(a)
        q -= a * y
    if S:
        gamma = S[-1].dot(Y[-1]) / Y[-1].dot(Y[-1])
        q *= gamma
    for (s, y, rho), a in zip(zip(S, Y, R), reversed(alphas)):
        b = rho * y.dot(q)
        q += (a - b) * s
    return -q


def minimize_host(
    value_and_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    x0: np.ndarray,
    *,
    maxiter: int,
    memory_size: int = 50,
    max_linesearch_steps: int = 50,
    c1: float = 1e-4,
    c2: float = 0.9,
    ftol: float = 1e-5 * np.finfo(np.float64).eps,
    gtol: float = 0.0,
    patience: int = 20,
    target: float = -np.inf,
    wall_budget: Optional[float] = None,
    init_carry: Optional[dict] = None,
    on_iter: Optional[Callable] = None,
    curvature_eps: float = 1e-10,
) -> HostLBFGSResult:
    """Minimize with host-f64 L-BFGS + strong-Wolfe zoom line search.

    ``value_and_grad`` maps a float64 vector to (float64 loss, float64 grad)
    — typically :func:`make_host_phase_vg`'s, whose compute is f32 on the
    device.  ``init_carry``/``result.carry`` persist curvature memory
    across calls (dict of arrays — picklable for checkpoints).
    ``on_iter(k, x, f)`` runs every iteration (logging / checkpoint hooks).
    Curvature pairs with y·s <= curvature_eps·|y||s| are skipped (cautious
    update: f32 gradient noise must not poison the inverse-Hessian model).
    """
    x = np.asarray(x0, np.float64).copy()
    t_end = time.time() + wall_budget if wall_budget else None

    S: List[np.ndarray] = []
    Y: List[np.ndarray] = []
    R: List[float] = []
    n_evals = 0

    def vg(z):
        nonlocal n_evals
        n_evals += 1
        f, g = value_and_grad(z)
        return float(f), np.asarray(g, np.float64)

    if init_carry is not None:
        S = [np.asarray(s) for s in init_carry["S"]]
        Y = [np.asarray(y) for y in init_carry["Y"]]
        R = [float(r) for r in init_carry["R"]]

    f, g = vg(x)
    history = [f]
    flat = 0
    status = "maxiter"
    k = 0

    def _linesearch(d, dg, alpha0):
        """Strong-Wolfe zoom (Nocedal & Wright alg. 3.5/3.6) with an
        accept-best-seen fallback: under f32 gradient noise the curvature
        condition may be unattainable, but any f64-certified decrease is
        progress — returns (alpha, f, g) or None."""
        f0, g0d = f, dg
        best = None  # (alpha, f, g) with f < f0, Wolfe or not
        alpha, alpha_prev = alpha0, 0.0
        f_prev_ls, fd_prev = f0, g0d
        lo = hi = flo = None
        for ls in range(max_linesearch_steps):
            f_a, g_a = vg(x + alpha * d)
            fd_a = g_a.dot(d)
            if f_a < f0 and (best is None or f_a < best[1]):
                best = (alpha, f_a, g_a)
            if f_a > f0 + c1 * alpha * g0d or (ls > 0 and f_a >= f_prev_ls):
                lo, hi, flo = alpha_prev, alpha, f_prev_ls
                break
            if abs(fd_a) <= -c2 * g0d:
                return alpha, f_a, g_a
            if fd_a >= 0:
                lo, hi, flo = alpha, alpha_prev, f_a
                break
            alpha_prev, f_prev_ls, fd_prev = alpha, f_a, fd_a
            alpha = min(alpha * 2.0, 1e4)
        if lo is not None:
            for _ in range(max_linesearch_steps):
                a_mid = 0.5 * (lo + hi)
                f_m, g_m = vg(x + a_mid * d)
                fd_m = g_m.dot(d)
                if f_m < f0 and (best is None or f_m < best[1]):
                    best = (a_mid, f_m, g_m)
                if f_m > f0 + c1 * a_mid * g0d or f_m >= flo:
                    hi = a_mid
                else:
                    if abs(fd_m) <= -c2 * g0d:
                        return a_mid, f_m, g_m
                    if fd_m * (hi - lo) >= 0:
                        hi = lo
                    lo, flo = a_mid, f_m
                if abs(hi - lo) < 1e-16 * max(1.0, abs(lo)):
                    break
        return best

    for k in range(1, maxiter + 1):
        if t_end and time.time() > t_end:
            break
        d = _two_loop(g, S, Y, R)
        dg = d.dot(g)
        if dg >= 0:  # not a descent direction (noise-corrupted memory)
            S.clear(); Y.clear(); R.clear()
            d = -g
            dg = -g.dot(g)
        if dg == 0.0:
            status = "gtol"
            break

        # Gradient-descent first step: scale to unit step length (standard
        # cold-start guard against |g|-sized overshoot).
        alpha0 = 1.0 if S else min(1.0, 1.0 / max(np.linalg.norm(g), 1.0))
        hit = _linesearch(d, dg, alpha0)
        if hit is None and S:
            # Stale/noise-poisoned memory: restart memoryless before giving
            # up (scipy's implicit behavior via its restart heuristics).
            S.clear(); Y.clear(); R.clear()
            d = -g
            dg = -g.dot(g)
            hit = _linesearch(d, dg, min(1.0, 1.0 / max(np.linalg.norm(g),
                                                        1.0)))
        if hit is None:
            status = "linesearch"
            break
        alpha, f_new, g_new = hit

        x_new = x + alpha * d
        s = x_new - x
        y = g_new - g
        sy = s.dot(y)
        if sy > curvature_eps * np.linalg.norm(s) * np.linalg.norm(y):
            S.append(s); Y.append(y); R.append(1.0 / sy)
            if len(S) > memory_size:
                S.pop(0); Y.pop(0); R.pop(0)

        denom = max(abs(f), abs(f_new), 1.0)
        flat = flat + 1 if (f - f_new) <= ftol * denom else 0
        x, f, g = x_new, f_new, g_new
        history.append(f)
        if on_iter is not None:
            on_iter(k, x, f)
        if f <= target:
            status = "target"
            break
        if flat >= patience:
            status = "ftol"
            break
        if gtol > 0 and np.max(np.abs(g)) <= gtol:
            status = "gtol"
            break

    carry = {"S": S, "Y": Y, "R": R}
    return HostLBFGSResult(
        x=x, final_loss=f, n_iters=k, n_evals=n_evals,
        loss_history=np.asarray(history), converged=status, carry=carry,
    )
