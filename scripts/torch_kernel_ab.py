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
  -> 5), N = 65,536, order 1 (serving), and N = 103,711, order 2
  (``fused_mlp_jet_train``, the shape training launches);
* B4 ``fused_composite_jet``, the net-BC plate nets, N = 65,536, order 1,
  and N = 103,711, order 2 (``fused_composite_jet_train``);
* B2 ``fused_mlp_jet_bwd``, 3 -> 8 x 70 -> 5, N = 103,711, order 2;
* B3b ``fused_seed_jet_bwd``, Fourier64 widths, N = 103,711, order 2;
* B5 ``fused_composite_jet_bwd``, net-BC nets, N = 103,711, order 2;
* B2 and B3b at the wave, inverse and 3D widths (``WAVE_BWD``): W1
  3 -> 6 x 140 -> 7 at its 146,149 collocation points, W2's B3b (the
  Fourier64 seed, 128 -> 6 x 140 -> 7), I1 (W1's widths) at order 1 on
  118,329 points and at order 2 on its 4,000 acceleration sensors, one of
  M1's eight microbatches (109,592 points), W3 3 -> 8 x 80 -> 7, W4
  3 -> 8 x 100 -> 7 and E1 4 -> 6 x 100 -> 12; each also against its
  float64 plain version (``max_err``: the largest gap over a leaf's largest
  magnitude, at least 1).

It prints the card, each run's times, and one JSON line: per kernel the
base and changed times (the mean of each tree's two medians), their ratio,
and whether the two trees' outputs are bitwise equal.  With ``--sass`` it
also compiles both trees' ``fused_jet.cu`` and ``fused_jet_vjp.cu`` and
reports, per kernel instance of this tree (keyed by its demangled name
without the parameter list), whether its machine code (``cuobjdump -sass``,
addresses and encodings stripped) equals the base tree's instance of the
same name, or null where the base has none.  It imports no JAX.
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
# name -> (widths, points, order, full_dx): B2/B3b at the other cases' nets.
WAVE_BWD = {
    "W1": ([3] + [140] * 6 + [7], 146_149, 1, False),
    "W2": ([128] + [140] * 6 + [7], 146_149, 1, True),
    "I1_o1": ([3] + [140] * 6 + [7], 118_329, 1, False),
    "I1_o2": ([3] + [140] * 6 + [7], 4_000, 2, False),
    "M1": ([3] + [140] * 6 + [7], 109_592, 1, False),
    "W3": ([3] + [80] * 8 + [7], 124_830, 1, False),
    "W4": ([3] + [100] * 8 + [7], 150_470, 1, False),
    "E1": ([4] + [100] * 6 + [12], 225_074, 1, False),
}
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
        "fused_mlp_jet_train": lambda: fj.fused_seed_jet_stack(tail, *sb),
        "fused_composite_jet_train": lambda: fj.fused_composite_jet_stack(
            net, xb, order=2),
        "fused_mlp_jet_bwd": lambda: fv.fused_mlp_jet_bwd(
            raw, *raw_seed, cot, full_dx=False),
        "fused_seed_jet_bwd": lambda: fv.fused_mlp_jet_bwd(
            tail, *sb, cot, full_dx=True),
        "fused_composite_jet_bwd": lambda: fv.fused_composite_jet_bwd(
            net, xb, cot, order=2),
    }
    refs = {}
    for key, (dims, n, order, full_dx) in WAVE_BWD.items():
        a = dims[0] if dims[0] in (3, 4) else 3
        params = _mlp(rng, dims, torch, dev)
        h0 = f32(rng.uniform(-1, 1, (n, dims[0])))
        d = f32(rng.standard_normal((a, n, dims[0])))
        dtt = f32(rng.standard_normal((n, dims[0]))) if order == 2 else None
        cot_w = f32(rng.standard_normal((1 + a + order - 1, n, dims[-1])))
        args = (params, h0, d, dtt, cot_w)
        name = ("fused_seed_jet_bwd_" if full_dx else "fused_mlp_jet_bwd_") + key
        kernels[name] = (lambda args=args, full_dx=full_dx:
                         fv.fused_mlp_jet_bwd(*args, full_dx=full_dx))
        refs[name] = (args, full_dx)
    out = {}
    for name, fn in kernels.items():
        got = fn()
        digest = _digest(tree_leaves(got))
        max_err = None
        if name in refs:
            (params, h0, d, dtt, cot_w), full_dx = refs[name]
            f64 = [{k: v.double() for k, v in layer.items()} for layer in params]
            want, want_seed = fv.mlp_jet_bwd_reference(
                f64, h0.double(), d.double(),
                None if dtt is None else dtt.double(), cot_w.double())
            want = (want, want_seed if full_dx else want_seed[0])
            max_err = max(
                float((g.double() - w).abs().max())
                / max(1.0, float(w.abs().max()))
                for g, w in zip(tree_leaves(got), tree_leaves(want)))
            del want, want_seed
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
        out[name] = {"ms": float(np.median(times)), "digest": digest,
                     "max_err": max_err}
    return out


def _cubin_jobs(tree: str, tmp: str) -> list:
    """Start compiling a tree's two sources to cubins: [(path, process)]."""
    from pinn_elastodynamics_torch.kernels import _native

    flags = [f for f in _native.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    jobs = []
    for source in ("fused_jet.cu", "fused_jet_vjp.cu"):
        cubin = os.path.join(tmp, f"{abs(hash(tree))}_{source}.cubin")
        src = os.path.join(tree, "pinn_elastodynamics_torch", "kernels",
                           "csrc", source)
        jobs.append((cubin, subprocess.Popen(
            [_native._nvcc(), *flags, *_native.SPLIT_FLAGS, "-cubin", "-o",
             cubin, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return jobs


def _sass(jobs: list) -> dict:
    """Instruction text of each kernel in the cubins, keyed by its demangled
    name up to the parameter list."""
    from pinn_elastodynamics_torch.kernels import _native

    bindir = os.path.dirname(_native._nvcc())
    cuobjdump = shutil.which("cuobjdump") or os.path.join(bindir, "cuobjdump")
    filt = shutil.which("cu++filt") or os.path.join(bindir, "cu++filt")
    kernels = {}
    for cubin, job in jobs:
        log, _ = job.communicate(timeout=900)
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed for {cubin}:\n{log}")
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
        name = None
        for line in text.splitlines():
            head = re.match(r"\s*Function : (\S+)", line)
            if head:
                name = subprocess.run([filt, head.group(1)], check=True,
                                      capture_output=True, text=True,
                                      timeout=30).stdout.strip()
                # Drop the parameter list: what follows the template's ">".
                name = name.split(">(")[0] + ">" if ">(" in name else \
                    name.split("(")[0]
                kernels[name] = []
            elif name and "/*" in line and ";" in line:
                ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0])
                kernels[name].append(" ".join(ins.split()))
    return kernels


def compare_sass(base: str) -> dict:
    """Per kernel instance of this tree: equal to the base's instance of the
    same name (null where the base has none)?"""
    with tempfile.TemporaryDirectory() as tmp:
        ours = _cubin_jobs(HERE, tmp)
        theirs = _cubin_jobs(os.path.abspath(base), tmp)
        ours, theirs = _sass(ours), _sass(theirs)
    return {name: (theirs[name] == code if name in theirs else None)
            for name, code in sorted(ours.items())}


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
                    help="also compare every kernel's machine code")
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
            "max_err": {"base": base[0].get("max_err"),
                        "change": change[0].get("max_err")},
            "bitwise_equal": base[0]["digest"] == change[0]["digest"],
            "repeatable": (base[0]["digest"] == base[1]["digest"]
                           and change[0]["digest"] == change[1]["digest"]),
        }
    result = {"card": card(), "kernels": summary}
    if args.sass:
        sys.path.insert(0, HERE)
        try:
            result["sass_equal"] = compare_sass(args.base)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            result["sass_equal"] = {"error": str(exc)[-2000:]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
