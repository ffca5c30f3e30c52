#!/usr/bin/env python3
"""Short first check of the MLP backward kernel (B2, B3b) on a GPU.

    python3 scripts/torch_bwd_probe.py

Prints the card, what ``nvcc -Xptxas -v`` reports for each instance of
``mlp_jet_bwd_kernel`` (registers, stack, spills), and the build seconds of
the kernel library; then, for four nets (B2 at the plate's 3 -> 8 x 70 -> 5,
order 2; B3b at the Fourier64 tail 128 -> 8 x 70 -> 5, order 2; B3b at the
wave-confined 128 -> 140 x 6 -> 7, order 1; B2 at a 3D 4 -> 6 x 100 -> 3,
order 2) and N = 1,000 and 103,711, holds the kernel's gradients and seed
cotangent to the float64 plain version (scaled errors), checks that two
runs are bitwise equal, and times it with CUDA events (median of 10) at
N = 103,711; and holds B1 to float64 at the wave-confined widths.  Inputs
are random, from a numpy seed.  It imports no JAX.
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

CASES = (("B2 plate", [3] + [70] * 8 + [5], 3, 2, False),
         ("B3b Fourier64", [128] + [70] * 8 + [5], 3, 2, True),
         ("B3b wave-confined", [128] + [140] * 6 + [7], 3, 1, True),
         ("B2 3D", [4] + [100] * 6 + [3], 4, 2, False))


def ptxas_report() -> None:
    src = _native.SOURCES[1]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", os.path.join(tmp, "probe.o"), str(src)],
            capture_output=True, text=True, timeout=600)
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "mlp_jet_bwd" in line:
            print(line[line.find("mlp_jet_bwd_kernel"):][:40])
            for info in lines[i + 1:i + 4]:
                if "registers" in info or "spill" in info:
                    print("   ", info.strip())
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip())
    ptxas_report()
    t0 = time.perf_counter()
    _native.library()
    print(f"build {time.perf_counter() - t0:.2f} s")
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
                for _ in range(3):
                    run()
                times = []
                for _ in range(10):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                print(f"  {name} n={n}: {np.median(times):.4f} ms", flush=True)
        if name == "B3b wave-confined":
            h0 = f32(rng.uniform(-1, 1, (1000, 128)))
            d = f32(rng.standard_normal((3, 1000, 128)))
            out = fj.fused_seed_jet_stack(params, h0, d)
            ref = fj.stack_jet(fj.fused_seed_jet_reference(
                f64(params), h0.double(), d.double()))
            print(f"B1 wave-confined n=1000: {scaled(out, ref):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
