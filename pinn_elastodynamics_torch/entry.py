"""The framework's entry points: the flagship's forward, and a dry run of the
full training step over a world of ranks.

    python -m pinn_elastodynamics_torch.entry [n] [--device cuda|cpu]
                                              [--backend nccl|gloo]

:func:`entry` returns the quarter plate's net-BC composite forward and its
example arguments.  :func:`dryrun_multichip` runs, in every rank of a
world of ``n`` (``parallel/launch.py::run_world``: NCCL with one rank per
card, or gloo), the JAX package's multi-device dry run at its settings:
the plate's banks at scale 0.002 padded to 2·n and sharded over the ranks,
the parameters replicated, then

1. one Adam step (lr 1e-3) and a 3-iteration L-BFGS segment over the
   sharded loss;
2. the loss in 2 microbatches of each rank's collocation shard:
   value+grad and the gradient's global norm;
3. the same loss on the fused-kernel route (``jet_impl="kernel"``; on the
   card B4 and B5, on the CPU their plain versions): value+grad and the
   global norm;
4. the analytic-BC + Fourier8 plate: a 3-iteration L-BFGS segment (on the
   card B1 seeded and B3b).

Rank 0 prints the four lines the JAX dry run prints, with its wording and
keys, so the two read side by side; the parent checks that every value is
finite and that the ranks agree bit for bit, and prints one line more:
the backend, the world size, each rank's card, the wall time of each piece
and the collectives made.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .cases import plate_hole
from .device import resolve_device
from .parallel import mesh as pmesh
from .parallel.launch import run_world
from .train.checkpoint import numpy_mlp
from .utils.tree import flat_numpy, tree_leaves

SCALE = 0.002
ADAM_LR = 1e-3
LBFGS_ITERS = 3
MICROBATCHES = 2
ANALYTIC = dict(bc="analytic", fourier=8, fourier_scale=2.0)
N_EXAMPLE = 256


def entry(device="cuda"):
    """(forward, (params, xyt)): the net-BC composite plate model's
    forward, ``(params, xyt) -> (256, 5)`` fields [u, v, s11, s22, s12],
    with parameters from a seeded ``torch.Generator`` and 256 example
    points from ``numpy.random.default_rng(0)``, in float32 on
    ``device``."""
    dev = resolve_device(device)
    model = plate_hole.build_model()
    params = model.init(torch.Generator().manual_seed(0), torch.float32, dev)

    def forward(params, xyt):
        return model.apply(params, xyt)

    xyt = torch.as_tensor(
        np.random.default_rng(0).uniform(0.0, 0.5, (N_EXAMPLE, 3)),
        dtype=torch.float32, device=dev)
    return forward, (params, xyt)


def seeded_trees(seed: int = 0) -> dict:
    """Parameters (JAX layout, numpy f32; Xavier weights, zero biases) of
    the dry run's two models, from a numpy seed: ``net_bc`` (uv, dist,
    part) and ``analytic`` (the uv net's Fourier matrix ``B`` and MLP)."""
    rng = np.random.default_rng(seed)
    net = plate_hole.build_model()
    uv = plate_hole.build_model(**ANALYTIC).uv_model
    b = uv.feature_scale * rng.standard_normal((uv.spec.n_inputs,
                                                uv.n_features))
    return {
        "net_bc": {k: numpy_mlp(rng, getattr(net, f"{k}_net").layers)
                   for k in ("uv", "dist", "part")},
        "analytic": {"uv": {"B": b.astype(np.float32),
                            "mlp": numpy_mlp(rng, uv.layers)}},
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def dryrun_pieces(trees, pad: int, device, mesh=None) -> dict:
    """The dry run's four pieces on the plate's banks padded to ``pad``,
    sharded over ``mesh`` (None: one process, no sharding).  Returns each
    piece's numbers, the final parameters as flat arrays, the L-BFGS
    evaluation counts, and per piece its wall seconds, kernel launches
    and collectives."""
    from .kernels import fused_jet as fj
    from .kernels import fused_jet_vjp as fv
    from .train import lbfgs
    from .train.adam import Adam
    from .train.checkpoint import params_from_jax
    from .train.step import (make_grad_step, make_microbatched_loss_fn,
                             value_and_grad)

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if mesh is None:
        shard = place = lambda x: x
    else:
        shard = lambda banks: pmesh.shard_banks(banks, mesh)
        place = lambda tree: pmesh.replicate(tree, mesh)
    out = {"seconds": {}, "launches": {}, "collectives": {}}

    def piece(name, run):
        sync()
        fj.reset_launches()
        fv.reset_launches()
        pmesh.reset_collectives()
        start = time.perf_counter()
        result = run()
        sync()
        out["seconds"][name] = time.perf_counter() - start
        out["launches"][name] = {**fj.LAUNCHES, **fv.LAUNCHES}
        out["collectives"][name] = dict(pmesh.COLLECTIVES)
        return result

    def segment(case, banks, params):
        evals = []

        def loss(p):
            evals.append(1)
            return case.loss.evaluate(case.model, p, case.material, banks)[0]

        res = lbfgs.minimize(loss, params, maxiter=LBFGS_ITERS,
                             segment=LBFGS_ITERS)
        return float(res.final_loss), flat_numpy(res.params), len(evals)

    # 1. One Adam step, then an L-BFGS segment, over the sharded banks.
    case = plate_hole.build(scale=SCALE, pad_to_multiple_of=pad, device=dev)
    banks = shard(case.banks)
    params = place(params_from_jax(trees["net_bc"], device=dev))
    opt = Adam(ADAM_LR)
    state = place(opt.init(params))
    step = make_grad_step(case.model, case.loss, case.material, opt)
    params, state, loss, comps = piece(
        "adam", lambda: step(params, state, banks))
    out["adam_loss"] = float(loss)
    out["components"] = {k: float(v) for k, v in sorted(comps.items())}
    out["adam_params"] = flat_numpy(params)
    (out["lbfgs_loss"], out["lbfgs_params"],
     out["lbfgs_evals"]) = piece("lbfgs", lambda: segment(case, banks, params))

    # 2. The microbatched loss, at the parameters after the Adam step.
    micro = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                      num_microbatches=MICROBATCHES)
    (mval, _), mgrads = piece("micro", lambda: value_and_grad(
        lambda p: micro(p, banks), params, has_aux=True))
    out["micro_loss"] = float(mval)
    out["micro_grad_norm"] = float(global_norm(mgrads))

    # 3. The fused-kernel route.
    case_k = plate_hole.build(scale=SCALE, pad_to_multiple_of=pad,
                              jet_impl="kernel", device=dev)
    banks_k = shard(case_k.banks)
    kval, kgrads = piece("kernel", lambda: value_and_grad(
        lambda p: case_k.loss.evaluate(case_k.model, p, case_k.material,
                                       banks_k)[0], params))
    out["kernel_loss"] = float(kval)
    out["kernel_grad_norm"] = float(global_norm(kgrads))

    # 4. The analytic-BC + Fourier8 plate: an L-BFGS segment.
    case_a = plate_hole.build(scale=SCALE, pad_to_multiple_of=pad,
                              device=dev, **ANALYTIC)
    banks_a = shard(case_a.banks)
    params_a = place(params_from_jax(trees["analytic"], device=dev))
    (out["analytic_loss"], out["analytic_params"],
     out["analytic_evals"]) = piece(
        "analytic", lambda: segment(case_a, banks_a, params_a))
    return out


def dryrun_lines(n: int, res: dict) -> list:
    """The four lines of the JAX package's dry run, from one rank's
    results; the third keeps its label for the fused-kernel route."""
    head = f"dryrun_multichip({n}):"
    return [
        f"{head} sharded Adam step + L-BFGS segment OK, "
        f"adam_loss={res['adam_loss']:.6f}, "
        f"lbfgs_loss={res['lbfgs_loss']:.6f}, "
        f"components={res['components']}",
        f"{head} microbatched remat loss OK, loss={res['micro_loss']:.6f}, "
        f"grad_norm={res['micro_grad_norm']:.4f}",
        f"{head} pallas-jet value_and_grad OK, "
        f"loss={res['kernel_loss']:.6f}, "
        f"grad_norm={res['kernel_grad_norm']:.4f}",
        f"{head} analytic-BC + Fourier L-BFGS segment OK, "
        f"loss={res['analytic_loss']:.6f}",
    ]


def _dryrun_rank(mesh, payload) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    out = dryrun_pieces(payload["trees"], 2 * mesh.size, mesh.device, mesh)
    out["card"] = (torch.cuda.get_device_name(mesh.device)
                   if mesh.device.type == "cuda" else "cpu")
    out["backend"] = str(dist.get_backend(mesh.group))
    if mesh.rank == 0:
        for line in dryrun_lines(mesh.size, out):
            print(line, flush=True)
    return out


# The results every rank must hold bit for bit.
SAME_ON_EVERY_RANK = (
    "adam_loss", "components", "adam_params", "lbfgs_loss", "lbfgs_params",
    "lbfgs_evals", "micro_loss", "micro_grad_norm", "kernel_loss",
    "kernel_grad_norm", "analytic_loss", "analytic_params", "analytic_evals")


def _check(ranks: list) -> None:
    """Every value finite, and the ranks bitwise equal."""
    for key in SAME_ON_EVERY_RANK:
        first = ranks[0][key]
        values = (list(first.values()) if isinstance(first, dict)
                  else np.atleast_1d(first))
        if not np.isfinite(np.asarray(values, np.float64)).all():
            raise RuntimeError(f"dry run: {key} is not finite: {first}")
        for r, res in enumerate(ranks[1:], 1):
            got = res[key]
            same = (np.array_equal(got, first) if isinstance(first, np.ndarray)
                    else got == first)
            if not same:
                raise RuntimeError(f"dry run: {key} differs between ranks 0 "
                                   f"and {r}: {first!r} against {got!r}")


def dryrun_multichip(n_devices: int, *, device="cuda", backend=None,
                     trees=None) -> list:
    """The dry run in a world of ``n_devices`` ranks (see the module
    docstring); returns every rank's results.

    ``device="cuda"`` runs NCCL with one rank per card and raises if the
    machine has fewer cards; ``backend="gloo"`` shares the cards instead;
    ``device="cpu"`` runs gloo on the host.  ``trees`` holds the net-BC and
    analytic models' parameters in the JAX layout (``net_bc``,
    ``analytic``; numpy); the default is :func:`seeded_trees`.
    """
    ranks = run_world(_dryrun_rank, n_devices, device=device,
                      backend=backend,
                      payload={"trees": trees or seeded_trees(0)})
    _check(ranks)
    first = ranks[0]
    seconds = {k: round(v, 4) for k, v in first["seconds"].items()}
    print(f"dryrun_multichip({n_devices}): world of {n_devices} over "
          f"{first['backend']}, cards "
          f"{[r['card'] for r in ranks]}, seconds {seconds}, collectives "
          f"{first['collectives']}, ranks bitwise equal", flush=True)
    return ranks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pinn_elastodynamics_torch.entry",
        description="A multi-rank dry run of the training step, then the "
                    "flagship forward.")
    parser.add_argument("n", type=int, nargs="?", default=None,
                        help="ranks (default: the cards; 2 on the CPU)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = parser.parse_args(argv)
    resolve_device(args.device)
    n = args.n
    if n is None:
        n = torch.cuda.device_count() if args.device == "cuda" else 2
    dryrun_multichip(n, device=args.device, backend=args.backend)
    fn, (params, xyt) = entry(args.device)
    with torch.no_grad():
        out = fn(params, xyt)
    print("entry forward:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
