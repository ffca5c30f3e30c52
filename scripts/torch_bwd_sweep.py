#!/usr/bin/env python3
"""Item shapes of the wide-tile MLP backward kernel (B2, B3b), timed on a GPU.

    python3 scripts/torch_bwd_sweep.py [--runs 20]

``mlp_jet_bwd_kernel`` (``kernels/csrc/fused_jet_vjp.cu``) blocks its
products by FB output features per item and its weight gradient by KB rows
and JB columns; the block has one thread per item of the widest hidden
layer, at most MAX_THREADS.  This script compiles the kernel source once per
variant of those constants (all ``nvcc`` calls started together, into a
temporary directory), binds each library with ``ctypes``, and for B2
(3 -> 8 x 70 -> 5) and B3b (128 -> 8 x 70 -> 5), N = 103,711, order 2, checks
each variant's gradients and seed cotangent against the first variant's
(within 2e-4 scaled) and times it with CUDA events (median of ``--runs``
after warm-up).  It prints the card and one JSON line.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SEED = 20261017
N = 103_711
# (FB, KB, JB, MAX_THREADS); the first is the source as committed.
VARIANTS = [(2, 5, 4, 512), (1, 5, 4, 512), (3, 5, 4, 512), (2, 4, 4, 512),
            (2, 8, 2, 512), (4, 5, 4, 512)]


def build(tmp: str) -> list:
    from pinn_elastodynamics_torch.kernels import _native

    nvcc = _native._nvcc()
    fwd, bwd = _native.SOURCES
    fwd_obj = os.path.join(tmp, "fwd.o")
    jobs = [subprocess.Popen([nvcc, *_native.NVCC_FLAGS, "-c", "-o", fwd_obj,
                              str(fwd)])]
    # FB and MAX_THREADS are in jet_wide.cuh, KB and JB in the source: each
    # variant compiles from a directory of its own copies.
    files = {path.name: path.read_text() for path in (bwd, *_native.HEADERS)}
    objs = []
    for i, (fb, kb, jb, mt) in enumerate(VARIANTS):
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        texts = dict(files)
        for name, value in (("FB", fb), ("KB", kb), ("JB", jb),
                            ("MAX_THREADS", mt)):
            hits = 0
            for fname, text in texts.items():
                texts[fname], n = re.subn(
                    rf"^constexpr int {name} = \d+;",
                    f"constexpr int {name} = {value};", text, flags=re.M)
                hits += n
            assert hits == 1, name
        for fname, text in texts.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        objs.append(os.path.join(d, "bwd.o"))
        jobs.append(subprocess.Popen([nvcc, *_native.NVCC_FLAGS, "-c", "-o",
                                      objs[-1], os.path.join(d, bwd.name)]))
    if any(job.wait(timeout=900) != 0 for job in jobs):
        raise RuntimeError("a variant failed to build")
    libs = []
    for i, obj in enumerate(objs):
        so = os.path.join(tmp, f"libv{i}.so")
        subprocess.run([nvcc, *_native.NVCC_FLAGS, "-shared", "-o", so,
                        fwd_obj, obj], check=True, timeout=300)
        libs.append(_native.bind(so))
    return libs


def launch(lib, params, h0, d, dtt, cot, full_dx):
    """fused_jet_vjp._launch_mlp_bwd with a given library."""
    import torch

    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.kernels.fused_jet import (
        _int_array,
        pack_params,
    )

    dev = h0.device
    packed, dims = pack_params(params, dev)
    n, e = h0.shape
    a = d.shape[0]
    s = cot.shape[0]
    per_block = lib.fused_mlp_jet_bwd_workspace(a, 2, _int_array(dims),
                                                len(params))
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((blocks, packed.numel()), device=dev)
    workspace = torch.empty(blocks * per_block, device=dev)
    grad = torch.empty_like(packed)
    dseed = torch.empty((s, n, e) if full_dx else (n, e), device=dev)
    err = lib.fused_mlp_jet_bwd_launch(
        h0.data_ptr(), d.data_ptr(), dtt.data_ptr(), cot.data_ptr(), n, a, 2,
        packed.data_ptr(), _int_array(dims), len(params), int(full_dx),
        blocks, partial.data_ptr(), grad.data_ptr(), dseed.data_ptr(),
        workspace.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return fv._unpack_grads(grad, dims), dseed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def mlp(dims):
        return [{"W": f32(rng.standard_normal((i, o)) * np.sqrt(2 / (i + o))),
                 "b": f32(0.1 * rng.standard_normal(o))}
                for i, o in zip(dims[:-1], dims[1:])]

    cases = {}
    for name, e, full_dx in (("B2", 3, False), ("B3b", 128, True)):
        cases[name] = (mlp([e] + [70] * 8 + [5]),
                       f32(rng.uniform(-1, 1, (N, e))),
                       f32(rng.standard_normal((3, N, e))),
                       f32(rng.standard_normal((N, e))),
                       f32(rng.standard_normal((5, N, 5))), full_dx)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        out = []
        first = {}
        for variant, lib in zip(VARIANTS, libs):
            row = {"FB": variant[0], "KB": variant[1], "JB": variant[2],
                   "MAX_THREADS": variant[3]}
            for name, (params, h0, d, dtt, cot, full_dx) in cases.items():
                got = tree_leaves(launch(lib, params, h0, d, dtt, cot, full_dx))
                first.setdefault(name, got)
                err = max(float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
                          for g, r in zip(got, first[name]))
                if not err <= 2e-4:
                    raise AssertionError(f"{row} {name}: differs by {err:.2e}")
                for _ in range(3):
                    launch(lib, params, h0, d, dtt, cot, full_dx)
                times = []
                for _ in range(args.runs):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    launch(lib, params, h0, d, dtt, cot, full_dx)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                row[name + "_ms"] = float(np.median(times))
            print(row, flush=True)
            out.append(row)
    print(json.dumps({"variants": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
