#!/usr/bin/env python3
"""Short first check of the backward kernels (B2, B3b, B5) on a GPU.

    python3 scripts/torch_bwd_probe.py

Prints the card, what ``nvcc -Xptxas -v`` reports for each instance of
``mlp_jet_bwd_kernel`` and ``composite_jet_bwd_kernel`` (registers, stack,
spills), and the build seconds of the kernel library; then, for four nets
(B2 at the plate's 3 -> 8 x 70 -> 5, order 2; B3b at the Fourier64 tail
128 -> 8 x 70 -> 5, order 2; B3b at the wave-confined 128 -> 140 x 6 -> 7,
order 1; B2 at a 3D 4 -> 6 x 100 -> 3, order 2) and N = 1,000 and 103,711,
holds the kernel's gradients and seed cotangent to the float64 plain
version (scaled errors), checks that two runs are bitwise equal, and times
it with CUDA events (median of 10) at N = 103,711; holds B1 to float64 at
the wave-confined widths; and does the same for B5 at the net-BC plate
nets (uv 3 -> 8 x 70 -> 5, dist and part 3 -> 4 x 20 -> 5), order 1 and 2,
raw and lb/ub-normalised coordinates, timed at N = 103,711, order 2, and
with a 140-wide uv net (3 -> 3 x 140 -> 5, the 16-point tile) at N = 1,000.
Inputs are random, from a numpy seed.  It imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pinn_elastodynamics_torch.kernels import _native  # noqa: E402
from pinn_elastodynamics_torch.kernels import fused_jet as fj  # noqa: E402
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv  # noqa: E402
from pinn_elastodynamics_torch.utils.tree import tree_leaves  # noqa: E402

PLATE_LB, PLATE_UB = (0.0, 0.0, 0.0), (0.5, 0.5, 10.0)
CASES = (("B2 plate", [3] + [70] * 8 + [5], 3, 2, False),
         ("B3b Fourier64", [128] + [70] * 8 + [5], 3, 2, True),
         ("B3b wave-confined", [128] + [140] * 6 + [7], 3, 1, True),
         ("B2 3D", [4] + [100] * 6 + [3], 4, 2, False))


def ptxas_start(tmp: str) -> subprocess.Popen:
    """Compile the backward source with ``-Xptxas -v``, in the background."""
    return subprocess.Popen(
        [_native._nvcc(), *_native.NVCC_FLAGS, *_native.SPLIT_FLAGS,
         "-Xptxas", "-v", "-c",
         "-o", os.path.join(tmp, "probe.o"), str(_native.SOURCES[1])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_report(proc: subprocess.Popen) -> None:
    _, err = proc.communicate(timeout=900)
    lines = err.splitlines()
    for i, line in enumerate(lines):
        name = next((k for k in ("mlp_jet_bwd_kernel",
                                 "composite_jet_bwd_kernel") if k in line), None)
        if "Compiling entry" in line and name:
            print(line[line.find(name):][:46])
            for info in lines[i + 1:i + 4]:
                if "registers" in info or "spill" in info:
                    print("   ", info.strip())
    if proc.returncode != 0:
        raise RuntimeError(err)


def median_ms(fn, warmup=3, runs=10) -> float:
    """Median milliseconds of ``fn`` by CUDA events."""
    for _ in range(warmup):
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
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        report = ptxas_start(tmp)   # alongside the library's build
        t0 = time.perf_counter()
        _native.library()
        print(f"build {time.perf_counter() - t0:.2f} s")
        ptxas_report(report)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def mlp(dims):
        return [{"W": f32(rng.standard_normal((i, o)) * np.sqrt(2 / (i + o))),
                 "b": f32(0.1 * rng.standard_normal(o))}
                for i, o in zip(dims[:-1], dims[1:])]

    def f64(params):
        return [{k: v.double() for k, v in layer.items()} for layer in params]

    def scaled(got, ref):
        return (float((got.double() - ref).abs().max())
                / max(1.0, float(ref.abs().max())))

    for name, dims, a, order, full_dx in CASES:
        params = mlp(dims)
        for n in (1000, 103_711):
            e = dims[0]
            h0 = f32(rng.uniform(-1, 1, (n, e)))
            d = f32(rng.standard_normal((a, n, e)))
            dtt = f32(rng.standard_normal((n, e))) if order == 2 else None
            cot = f32(rng.standard_normal((1 + a + order - 1, n, dims[-1])))

            def run():
                return fv.fused_mlp_jet_bwd(params, h0, d, dtt, cot,
                                            full_dx=full_dx)

            first, second = run(), run()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in
                       zip(tree_leaves(first), tree_leaves(second)))
            ref_g, ref_x = fv.mlp_jet_bwd_reference(
                f64(params), h0.double(), d.double(),
                None if dtt is None else dtt.double(), cot.double())
            ref_x = ref_x if full_dx else ref_x[0]
            err_g = max(scaled(g, r) for g, r in
                        zip(tree_leaves(first[0]), tree_leaves(ref_g)))
            print(f"{name} n={n}: grads {err_g:.3e}, dx "
                  f"{scaled(first[1], ref_x):.3e}, bitwise {same}", flush=True)
            if n == 103_711:
                print(f"  {name} n={n}: {median_ms(run):.4f} ms", flush=True)
        if name == "B3b wave-confined":
            h0 = f32(rng.uniform(-1, 1, (1000, 128)))
            d = f32(rng.standard_normal((3, 1000, 128)))
            out = fj.fused_seed_jet_stack(params, h0, d)
            ref = fj.stack_jet(fj.fused_seed_jet_reference(
                f64(params), h0.double(), d.double()))
            print(f"B1 wave-confined n=1000: {scaled(out, ref):.3e}")

    net = {"uv": mlp([3] + [70] * 8 + [5]), "dist": mlp([3] + [20] * 4 + [5]),
           "part": mlp([3] + [20] * 4 + [5])}
    net64 = {k: f64(v) for k, v in net.items()}
    for n in (1000, 103_711):
        x = f32(np.concatenate([rng.uniform(0, 0.5, (n, 2)),
                                rng.uniform(0, 10, (n, 1))], 1))
        for order in (1, 2):
            cot = f32(rng.standard_normal((3 + order, n, 5)))
            for lb, ub in ((None, None), (PLATE_LB, PLATE_UB)):
                label = f"B5 {'lb/ub' if lb else 'raw'} n={n} order={order}"

                def run():
                    return fv.fused_composite_jet_bwd(net, x, cot, order=order,
                                                      lb=lb, ub=ub)

                first, second = run(), run()
                torch.cuda.synchronize()
                same = all(torch.equal(u, v) for u, v in
                           zip(tree_leaves(first), tree_leaves(second)))
                ref_g, ref_x = fv.composite_jet_bwd_reference(
                    net64, x.double(), cot.double(), order=order, lb=lb, ub=ub)
                err_g = max(scaled(g, r) for g, r in
                            zip(tree_leaves(first[0]), tree_leaves(ref_g)))
                print(f"{label}: grads {err_g:.3e}, dx "
                      f"{scaled(first[1], ref_x):.3e}, bitwise {same}",
                      flush=True)
                if n == 103_711 and order == 2 and lb is None:
                    print(f"  B5 n={n} order=2: {median_ms(run):.4f} ms",
                          flush=True)

    # A 140-wide uv net: the 16-point tile with one weight buffer.
    wide = dict(net, uv=mlp([3] + [140] * 3 + [5]))
    wide64 = {k: f64(v) for k, v in wide.items()}
    x = f32(np.concatenate([rng.uniform(0, 0.5, (1000, 2)),
                            rng.uniform(0, 10, (1000, 1))], 1))
    for order in (1, 2):
        cot = f32(rng.standard_normal((3 + order, 1000, 5)))
        first = fv.fused_composite_jet_bwd(wide, x, cot, order=order,
                                           lb=PLATE_LB, ub=PLATE_UB)
        second = fv.fused_composite_jet_bwd(wide, x, cot, order=order,
                                            lb=PLATE_LB, ub=PLATE_UB)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in
                   zip(tree_leaves(first), tree_leaves(second)))
        ref_g, ref_x = fv.composite_jet_bwd_reference(
            wide64, x.double(), cot.double(), order=order, lb=PLATE_LB,
            ub=PLATE_UB)
        err_g = max(scaled(g, r) for g, r in
                    zip(tree_leaves(first[0]), tree_leaves(ref_g)))
        print(f"B5 uv 140 wide lb/ub n=1000 order={order}: grads "
              f"{err_g:.3e}, dx {scaled(first[1], ref_x):.3e}, bitwise {same}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
