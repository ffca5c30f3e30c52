#!/usr/bin/env python3
"""The port's value+grad in two trees, timed in turns on one GPU.

    python3 scripts/torch_loss_ab.py --base DIR [--runs 20]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  The script runs a worker process
for the base tree, this tree, this tree and the base tree, in that order.
Each worker imports ``pinn_elastodynamics_torch`` from its tree (building
that tree's kernels on first use), builds three configurations at scale 1.0
with random weights from a numpy seed, hashes one value+grad's loss and
gradients, then times the value+grad with CUDA events (median of ``--runs``
after warm-up):

* ``net_bc``: the net-BC plate's uv phase (B4, B5);
* ``analytic_fourier64``: the analytic + Fourier64 plate's ``uv.mlp``
  phase (B1 seeded, B3b);
* ``W1``: wave_confined soft, 3 -> 140 x 6 -> 7, every parameter (B1, B2).

It prints the card, each run's times, and one JSON line: per configuration
the base and changed times (the mean of each tree's two medians), their
ratio, and whether the two trees' losses and gradients are bitwise equal.
It imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

SEED = 20261017
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (case module, build kwargs, trainable path of the main phase)
CONFIGS = {
    "net_bc": ("plate_hole", {}, "uv"),
    "analytic_fourier64": ("plate_hole", dict(bc="analytic", fourier=64,
                                              fourier_scale=2.0), "uv.mlp"),
    "W1": ("wave_confined", {}, None),
}


def _tree(rng, model):
    """Random parameters of ``model`` in the JAX layout (numpy f32)."""
    import numpy as np

    def mlp(dims):
        return [{"W": (rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o))
                       ).astype(np.float32),
                 "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
                for i, o in zip(dims[:-1], dims[1:])]

    def net(m):
        if hasattr(m, "uv_net"):
            return {k: net(getattr(m, f"{k}_net"))
                    for k in ("dist", "part", "uv")}
        if hasattr(m, "uv_model"):
            return {"uv": net(m.uv_model)}
        tree = mlp(list(m.layers))
        if hasattr(m, "n_features"):
            b = m.feature_scale * rng.standard_normal((3, m.n_features))
            tree = {"B": b.astype(np.float32), "mlp": tree}
        return tree

    return net(model)


def worker(tree: str, runs: int) -> dict:
    sys.path.insert(0, tree)
    import importlib

    import numpy as np
    import torch

    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
    from pinn_elastodynamics_torch.train.step import value_and_grad
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    if not os.path.abspath(_phase_loss_fn.__code__.co_filename).startswith(
            os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported the package from outside {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out = {}
    for name, (mod_name, kw, trainable) in CONFIGS.items():
        mod = importlib.import_module(
            f"pinn_elastodynamics_torch.cases.{mod_name}")
        case = mod.build(scale=1.0, device=dev, **kw)
        params = params_from_jax(_tree(rng, case.model), device=dev)
        phase = dataclasses.replace(case.phases[-1], trainable=trainable)
        fn, sub, _ = _phase_loss_fn(case, phase, params)
        loss, grads = value_and_grad(fn, sub)
        h = hashlib.sha256()
        for t in [loss, *tree_leaves(grads)]:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        for _ in range(3):
            value_and_grad(fn, sub)
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            value_and_grad(fn, sub)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = {"ms": float(np.median(times)),
                     "loss_digest": hashlib.sha256(
                         loss.cpu().numpy().tobytes()).hexdigest()[:16],
                     "digest": h.hexdigest()[:16]}
        del case, params, fn, sub, grads
        torch.cuda.empty_cache()
    return out


def card() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30)
    return proc.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="the other tree")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.runs)), flush=True)
        return 0
    if not args.base:
        ap.error("--base is required")
    print(card(), flush=True)
    results = {"base": [], "change": []}
    for which in ("base", "change", "change", "base"):
        tree = os.path.abspath(args.base if which == "base" else HERE)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--runs", str(args.runs)],
            capture_output=True, text=True, timeout=900, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results[which].append(res)
        print(which, {k: round(v["ms"], 4) for k, v in res.items()},
              flush=True)
    summary = {}
    for name in CONFIGS:
        base = [r[name] for r in results["base"]]
        change = [r[name] for r in results["change"]]
        base_ms = sum(r["ms"] for r in base) / 2
        change_ms = sum(r["ms"] for r in change) / 2
        summary[name] = {
            "base_ms": base_ms, "change_ms": change_ms,
            "ratio": change_ms / base_ms,
            "runs_ms": {"base": [r["ms"] for r in base],
                        "change": [r["ms"] for r in change]},
            "loss_bitwise_equal": (base[0]["loss_digest"]
                                   == change[0]["loss_digest"]),
            "bitwise_equal": base[0]["digest"] == change[0]["digest"],
            "repeatable": (base[0]["digest"] == base[1]["digest"]
                           and change[0]["digest"] == change[1]["digest"]),
        }
    print(json.dumps({"card": card(), "value_and_grad": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
