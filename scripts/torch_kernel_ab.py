#!/usr/bin/env python3
"""The port's five CUDA jet kernels in two trees, timed in turns on one GPU.

    python3 scripts/torch_kernel_ab.py --base DIR [--runs 20]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  The script runs a worker process
for the base tree, this tree, this tree and the base tree, in that order.
Each worker imports ``pinn_elastodynamics_torch`` from its tree (building
that tree's kernels on first use), makes the same inputs from a numpy seed,
runs each kernel once and hashes its outputs, then times it with CUDA events
(median of ``--runs`` launches after warm-up):

* B1 ``fused_mlp_jet``, seeded at the Fourier64 plate widths (128 -> 8 x 70
  -> 5), N = 65,536, order 1;
* B4 ``fused_composite_jet``, the net-BC plate nets, N = 65,536, order 1;
* B2 ``fused_mlp_jet_bwd``, 3 -> 8 x 70 -> 5, N = 103,711, order 2;
* B3b ``fused_seed_jet_bwd``, Fourier64 widths, N = 103,711, order 2;
* B5 ``fused_composite_jet_bwd``, net-BC nets, N = 103,711, order 2.

It prints the card, each run's times, and one JSON line: per kernel the
base and changed times (the mean of each tree's two medians), their ratio,
and whether the two trees' outputs are bitwise equal.  With ``--sass`` it
also compiles both trees' ``fused_jet.cu`` and reports, per forward kernel
instance of this tree's 32-point tile, whether its machine code (``cuobjdump
-sass``, addresses and encodings stripped) equals the base tree's kernel of
the same streams.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

SEED = 20261017
N_FWD = 65536
N_BWD = 103_711
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(rng, dims, torch, dev):
    import numpy as np

    return [{"W": torch.as_tensor(rng.standard_normal((i, o))
                                  * np.sqrt(2.0 / (i + o)),
                                  dtype=torch.float32, device=dev),
             "b": torch.as_tensor(0.1 * rng.standard_normal(o),
                                  dtype=torch.float32, device=dev)}
            for i, o in zip(dims[:-1], dims[1:])]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: str, runs: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.models.mlp import seed_jet
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    if not os.path.abspath(fj.__file__).startswith(
            os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {fj.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    uv = [3] + [70] * 8 + [5]
    small = [3] + [20] * 4 + [5]
    four = [128] + [70] * 8 + [5]
    net = {"uv": _mlp(rng, uv, torch, dev), "dist": _mlp(rng, small, torch, dev),
           "part": _mlp(rng, small, torch, dev)}
    raw = _mlp(rng, uv, torch, dev)
    tail = _mlp(rng, four, torch, dev)

    def points(n):
        return f32(np.concatenate([rng.uniform(0, 0.5, (n, 2)),
                                   rng.uniform(0, 10, (n, 1))], 1))

    def seed(n, e, order):
        return (f32(rng.uniform(-1, 1, (n, e))),
                f32(rng.standard_normal((3, n, e))),
                f32(rng.standard_normal((n, e))) if order == 2 else None)

    xf, xb = points(N_FWD), points(N_BWD)
    sf = seed(N_FWD, 128, 1)
    raw_seed = tuple(t.contiguous() for t in seed_jet(xb, order=2))
    sb = seed(N_BWD, 128, 2)
    cot = f32(rng.standard_normal((5, N_BWD, 5)))
    kernels = {
        "fused_mlp_jet": lambda: fj.fused_seed_jet_stack(tail, *sf[:2]),
        "fused_composite_jet": lambda: fj.fused_composite_jet_stack(
            net, xf, order=1),
        "fused_mlp_jet_bwd": lambda: fv.fused_mlp_jet_bwd(
            raw, *raw_seed, cot, full_dx=False),
        "fused_seed_jet_bwd": lambda: fv.fused_mlp_jet_bwd(
            tail, *sb, cot, full_dx=True),
        "fused_composite_jet_bwd": lambda: fv.fused_composite_jet_bwd(
            net, xb, cot, order=2),
    }
    out = {}
    for name, fn in kernels.items():
        digest = _digest(tree_leaves(fn()))
        for _ in range(3):
            fn()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = {"ms": float(np.median(times)), "digest": digest}
    return out


def _sass(tree: str, tmp: str) -> dict:
    """Instruction text of each kernel in a tree's fused_jet.cu, keyed by a
    name without the file hash of the anonymous namespace."""
    from pinn_elastodynamics_torch.kernels import _native

    cubin = os.path.join(tmp, f"{abs(hash(tree))}.cubin")
    src = os.path.join(tree, "pinn_elastodynamics_torch", "kernels", "csrc",
                       "fused_jet.cu")
    flags = [f for f in _native.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_native._nvcc(), *flags, "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, timeout=600)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_native._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", head.group(1))
            kernels[name] = []
        elif name and "/*" in line and ";" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0])
            kernels[name].append(" ".join(ins.split()))
    return kernels


def compare_sass(base: str) -> dict:
    """Per 32-point forward kernel of this tree: equal to the base's?"""
    with tempfile.TemporaryDirectory() as tmp:
        ours, theirs = _sass(HERE, tmp), _sass(os.path.abspath(base), tmp)
    out = {}
    for name, code in ours.items():
        if "ELi32EE" not in name:
            continue
        # The same instance, or in a base tree without the tile parameter
        # the kernel of the same streams.
        twin = name if name in theirs else name.replace("ELi32EE", "EE")
        out[name] = twin in theirs and theirs[twin] == code
    return out


def card() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30)
    return proc.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="the other tree")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="also compare the forward kernels' machine code")
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
    for name in results["base"][0]:
        base = [r[name] for r in results["base"]]
        change = [r[name] for r in results["change"]]
        base_ms = sum(r["ms"] for r in base) / 2
        change_ms = sum(r["ms"] for r in change) / 2
        summary[name] = {
            "base_ms": base_ms, "change_ms": change_ms,
            "ratio": change_ms / base_ms,
            "runs_ms": {"base": [r["ms"] for r in base],
                        "change": [r["ms"] for r in change]},
            "bitwise_equal": base[0]["digest"] == change[0]["digest"],
            "repeatable": (base[0]["digest"] == base[1]["digest"]
                           and change[0]["digest"] == change[1]["digest"]),
        }
    result = {"card": card(), "kernels": summary}
    if args.sass:
        sys.path.insert(0, HERE)
        result["forward_sass_equal"] = compare_sass(args.base)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
