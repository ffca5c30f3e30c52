#!/usr/bin/env python3
"""Design variants of the forward jet kernels (B1, B4), timed on a GPU.

    python3 scripts/torch_fwd_sweep.py [--runs 20] [--out FILE]

``mlp_jet_kernel`` and ``composite_jet_kernel`` (``kernels/csrc/fused_jet.cu``)
run the wide-tile layer of ``jet_wide.cuh``; each kernel's ``Design`` names
its items' output features, its thread bound and the tiles it may take, and
``FWD_NB`` the row buffers (two or, as the backward, three); B1 has one
design for four streams and one for more.  This script compiles
``fused_jet.cu`` once per variant in ``VARIANTS`` (all ``nvcc`` calls
started together, with ``-Xptxas -v``, into a temporary directory),
adds to each a query of the launch plan (tile, threads, shared bytes,
weight buffers, and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
a switch to a persistent grid, and times each variant under three grids:
one block per tile (the launchers' own), every resident block on every SM
walking tiles in order, and one block per SM.  Cases: B1 seeded at the
Fourier64 plate widths (128 -> 8 x 70 -> 5) and B4 at the net-BC nets (uv
3 -> 8 x 70 -> 5, dist and part 3 -> 4 x 20 -> 5), each at N = 65,536
order 1 and N = 103,711 order 2.  Every variant's outputs are compared
bitwise with the first variant's and held to the plain float64 version
within 1e-5 scaled (5e-5 on the second time derivative).  Times are
CUDA-event medians of ``--runs`` launches after warm-up.  It prints the
card, the registers and spills of every kernel instance, one line per
variant and case, and one JSON line (also written to ``--out``).  It
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SEED = 20261017
SHAPES = ((65536, 1), (103_711, 2))
# (FWD_NB, MlpDesign4, MlpDesign5, CompositeDesign), each design as
# "features per item, thread bound, tiles..."; the first is the source as
# committed, the second the backward's layout (three row buffers, 2-feature
# items, 32-point tiles).
VARIANTS = [
    (2, "4, 256, 56, 48, 32, 16, 8", "3, 384, 64, 40, 32, 16, 8",
     "3, 384, 64, 56, 48, 32, 16, 8"),
    (3, "2, 512, 32, 16, 8", "2, 512, 32, 16, 8", "2, 512, 32, 16, 8"),
    (2, "2, 512, 56, 48, 32, 16, 8", "2, 512, 56, 48, 32, 16, 8",
     "2, 512, 56, 48, 32, 16, 8"),
    (2, "1, 512, 56, 48, 32, 16, 8", "1, 512, 56, 48, 32, 16, 8",
     "1, 512, 56, 48, 32, 16, 8"),
    (2, "4, 256, 56, 48, 32, 16, 8", "4, 256, 56, 48, 32, 16, 8",
     "4, 256, 56, 48, 32, 16, 8"),
    (2, "3, 384, 64, 56, 48, 32, 16, 8", "2, 512, 64, 40, 32, 16, 8",
     "3, 384, 56, 48, 32, 16, 8"),
]
GRIDS = ("tiles", "resident", "one_per_sm")
TOL_FD, TOL_DTT = 1e-5, 5e-5

# Put before the launchers of each variant: a grid of at most max_blocks
# SMs' worth of resident blocks (0: one block per tile).
GRID_SWITCH = r"""
int sweep_max_blocks = 0;

template <class K>
int sweep_blocks(int tiles, K kern, const wide::Layout& lay, size_t bytes) {
  if (sweep_max_blocks <= 0) return tiles;
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, lay.threads,
                                                bytes);
  return std::max(1, std::min(tiles, sweep_max_blocks * std::max(1, per_sm)));
}

"""

# Appended to each variant: the grid switch's setter, and the launch plan
# of a net (kind 0, B1) or of the three composite nets (kind 1, B4).
PLAN_QUERY = r"""
namespace {
template <int S, bool DTT>
int sweep_plan_t(int kind, const Net* nets, int a, int* out) {
  wide::Layout lay;
  const size_t bytes = kind == 0 ? mlp_layout<S>(nets[0], &lay)
                                 : composite_layout(nets, S, a, &lay);
  if (bytes == 0) return -1;
  int per_sm = 0;
  if (kind == 0) {
    const auto k = mlp_kernel<S, DTT>(lay.T, MlpDesign<S>());
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, lay.threads,
                                                  bytes);
  } else {
    const auto k = composite_kernel<S, DTT>(lay.T, CompositeDesign());
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, lay.threads,
                                                  bytes);
  }
  out[0] = lay.T;
  out[1] = lay.threads;
  out[2] = static_cast<int>(bytes);
  out[3] = per_sm;
  out[4] = lay.wbuf[0] != lay.wbuf[1] ? 2 : 1;
  return 0;
}
}  // namespace

extern "C" void sweep_set_max_blocks(int m) { sweep_max_blocks = m; }

extern "C" int sweep_plan(int kind, int a, int order, const int* dims,
                          int n_layers, const int* small, int n_small,
                          int* out) {
  Net nets[3] = {};
  nets[0].n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) nets[0].dims[i] = dims[i];
  for (int j = 1; j < 3; ++j) {
    nets[j].n_layers = n_small;
    for (int i = 0; i <= n_small; ++i) nets[j].dims[i] = small[i];
  }
  switch (a * 2 + (order == 2 ? 1 : 0)) {
    case 6: return sweep_plan_t<4, false>(kind, nets, a, out);
    case 7: return sweep_plan_t<5, true>(kind, nets, a, out);
    case 8: return sweep_plan_t<5, false>(kind, nets, a, out);
    case 9: return sweep_plan_t<6, true>(kind, nets, a, out);
    default: return -1;
  }
}
"""


def ptxas_table(log: str) -> list:
    """(kernel, S, DTT, T, registers, spill stores, spill loads) per entry
    function that ``-Xptxas -v`` reported."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(mlp_jet_kernel|composite_jet_kernel)"
                          r"ILi(\d+)ELb([01])ELi(\d+)E", m.group(1))
            cur = [k.group(1), int(k.group(2)), k.group(3) == "1",
                   int(k.group(4)), None, None, None] if k else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur[5], cur[6] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[4] = int(m.group(1))
            rows.append(tuple(cur))
            cur = None
    return rows


def build(tmp: str):
    """One library per variant; returns [(lib, ptxas rows)]."""
    from pinn_elastodynamics_torch.kernels import _native

    nvcc = _native._nvcc()
    text = _native.SOURCES[0].read_text() + PLAN_QUERY
    jobs = []
    for i, (nb, mlp4, mlp5, comp) in enumerate(VARIANTS):
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        for header in _native.HEADERS:
            with open(os.path.join(d, header.name), "w") as f:
                f.write(header.read_text())
        src = text
        for pattern, value, count in (
                (r"^constexpr int FWD_NB = \d+;", f"constexpr int FWD_NB = {nb};",
                 1),
                (r"^using MlpDesign4 = Design<[\d, ]+>;",
                 f"using MlpDesign4 = Design<{mlp4}>;", 1),
                (r"^using MlpDesign5 = Design<[\d, ]+>;",
                 f"using MlpDesign5 = Design<{mlp5}>;", 1),
                (r"^using CompositeDesign = Design<[\d, ]+>;",
                 f"using CompositeDesign = Design<{comp}>;", 1),
                (r"const int blocks = \(n \+ lay\.T - 1\) / lay\.T;",
                 "const int blocks = sweep_blocks((n + lay.T - 1) / lay.T, "
                 "kern, lay, bytes);", 2)):
            src, n = re.subn(pattern, value, src, flags=re.M)
            assert n == count, pattern
        anchor = "template <int S, bool DTT>\nint launch_mlp("
        assert src.count(anchor) == 1
        src = src.replace(anchor, GRID_SWITCH + anchor)
        path = os.path.join(d, "fused_jet.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(d, "libfwd.so")
        cmd = [nvcc, *_native.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               so, path]
        jobs.append((so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    out = []
    for so, job in jobs:
        log, _ = job.communicate(timeout=900)
        if job.returncode != 0:
            raise RuntimeError(f"a variant failed to build:\n{log}")
        lib = ctypes.CDLL(so)
        _p, _i = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_jet_launch.argtypes = [
            _p, _p, _p, _i, _i, _i, _p, _p, _i, _p, _p]
        lib.fused_composite_jet_launch.argtypes = [
            _p, _i, _i, _i, _p, _p, _p, _p, _i, _p, _p, _i, _p, _p, _i, _p, _p]
        lib.sweep_plan.argtypes = [_i, _i, _i, _p, _i, _p, _i, _p]
        lib.sweep_set_max_blocks.argtypes = [_i]
        lib.sweep_set_max_blocks.restype = None
        for fn in (lib.fused_mlp_jet_launch, lib.fused_composite_jet_launch,
                   lib.sweep_plan):
            fn.restype = _i
        out.append((lib, ptxas_table(log)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    import numpy as np
    import torch

    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels.fused_jet import (
        _int_array,
        pack_params,
    )

    if not torch.cuda.is_available():
        print("torch_fwd_sweep: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def mlp(dims):
        return [{"W": f32(rng.standard_normal((i, o)) * np.sqrt(2 / (i + o))),
                 "b": f32(0.1 * rng.standard_normal(o))}
                for i, o in zip(dims[:-1], dims[1:])]

    four = [128] + [70] * 8 + [5]
    uv, small = [3] + [70] * 8 + [5], [3] + [20] * 4 + [5]
    tail = mlp(four)
    nets = {"uv": mlp(uv), "dist": mlp(small), "part": mlp(small)}
    packed_tail = pack_params(tail, dev)
    packed_nets = [pack_params(nets[k], dev) for k in ("uv", "dist", "part")]

    cases = {}
    for n, order in SHAPES:
        x = f32(np.concatenate([rng.uniform(0, 0.5, (n, 2)),
                                rng.uniform(0, 10, (n, 1))], 1))
        h0 = f32(rng.uniform(-1, 1, (n, 128)))
        d = f32(rng.standard_normal((3, n, 128)))
        dtt = f32(rng.standard_normal((n, 128))) if order == 2 else None
        s = 3 + order
        with torch.no_grad():
            ref_b1 = fj.stack_jet(fj.fused_seed_jet_reference(
                [{k: v.double() for k, v in layer.items()} for layer in tail],
                h0.double(), d.double(),
                None if dtt is None else dtt.double()))
            ref_b4 = fj.stack_jet(fj.fused_composite_jet_reference(
                {k: [{q: v.double() for q, v in layer.items()}
                     for layer in net] for k, net in nets.items()},
                x.double(), order=order))
        cases[f"B1_n{n}_o{order}"] = ("B1", n, order, (h0, d, dtt), ref_b1,
                                      torch.empty((s, n, 5), device=dev))
        cases[f"B4_n{n}_o{order}"] = ("B4", n, order, x, ref_b4,
                                      torch.empty((s, n, 5), device=dev))

    def launch(lib, case, max_blocks):
        kind, n, order, inp, _, out = case
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.sweep_set_max_blocks(max_blocks)
        if kind == "B1":
            h0, d, dtt = inp
            packed, dims = packed_tail
            err = lib.fused_mlp_jet_launch(
                h0.data_ptr(), d.data_ptr(),
                None if dtt is None else dtt.data_ptr(), n, 3, order,
                packed.data_ptr(), _int_array(dims), len(dims) - 1,
                out.data_ptr(), stream)
        else:
            a = []
            for packed, dims in packed_nets:
                a += [packed.data_ptr(), _int_array(dims), len(dims) - 1]
            err = lib.fused_composite_jet_launch(
                inp.data_ptr(), n, 3, order, None, None, *a, out.data_ptr(),
                stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    def plan(lib, kind, order):
        got = (ctypes.c_int * 5)()
        dims = four if kind == "B1" else uv
        if lib.sweep_plan(0 if kind == "B1" else 1, 3, order,
                          _int_array(dims), len(dims) - 1, _int_array(small),
                          len(small) - 1, got) != 0:
            raise RuntimeError("no plan")
        return dict(zip(("T", "threads", "smem_bytes", "blocks_per_sm",
                         "weight_buffers"), list(got)))

    def check(out, ref, label):
        scale = [max(1.0, float(r.abs().max())) for r in ref]
        errs = [float((o.double() - r).abs().max()) / sc
                for o, r, sc in zip(out, ref, scale)]
        limits = [TOL_FD] * len(errs)
        if ref.shape[0] == 5:
            limits[-1] = TOL_DTT
        if not all(e <= lim for e, lim in zip(errs, limits)):
            raise AssertionError(f"{label}: errors {errs}")
        return max(errs)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        print("registers and spills (kernel, S, DTT, T, registers, spill "
              "stores, spill loads), variant by variant:", flush=True)
        first, rows = {}, []
        for (nb, mlp4, mlp5, comp), (lib, regs) in zip(VARIANTS, libs):
            tag = f"NB={nb} B1<{mlp4}>/<{mlp5}> B4<{comp}>"
            print(f"  {tag}: {regs}", flush=True)
            row = {"NB": nb, "mlp_design4": mlp4, "mlp_design5": mlp5,
                   "composite_design": comp,
                   "ptxas": regs, "spills": any(r[5] or r[6] for r in regs)}
            for name, case in cases.items():
                kind, n, order = case[:3]
                p = plan(lib, kind, order)
                n_tiles = (n + p["T"] - 1) // p["T"]
                grids = {"tiles": 0, "resident": sms,
                         "one_per_sm": max(1, sms // max(1, p["blocks_per_sm"]))}
                out = launch(lib, case, 0).clone()
                err = check(out, case[4], f"{tag} {name}")
                first.setdefault(name, out)
                res = {**p, "tiles": n_tiles, "max_scaled_err": err,
                       "equal_to_first": bool(torch.equal(out, first[name]))}
                for g in GRIDS:
                    if not torch.equal(launch(lib, case, grids[g]), out):
                        raise AssertionError(f"{name}: grid {g} differs")
                    for _ in range(3):
                        launch(lib, case, grids[g])
                    times = []
                    for _ in range(args.runs):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        launch(lib, case, grids[g])
                        end.record()
                        end.synchronize()
                        times.append(start.elapsed_time(end))
                    res[g + "_ms"] = float(np.median(times))
                row[name] = res
                print(f"  {tag} {name}: T={p['T']} "
                      f"threads={p['threads']} smem={p['smem_bytes']} "
                      f"blocks/SM={p['blocks_per_sm']} "
                      f"wbufs={p['weight_buffers']} "
                      + " ".join(f"{g}={res[g + '_ms']:.4f}ms" for g in GRIDS)
                      + f" err={err:.2e} equal={res['equal_to_first']}",
                      flush=True)
            rows.append(row)
    line = json.dumps({"card": card, "sms": sms, "variants": rows})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
