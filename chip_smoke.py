#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused-jet CUDA kernels from ``pinn_elastodynamics_torch/kernels/
csrc/`` (one ``nvcc -c`` per source, started together, then one link; first
use only), then, in order:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds or loads the kernel libraries and prints the build seconds;
3. holds each forward kernel to its plain PyTorch version run in float64 on
   the card (B1 seeded at the Fourier64 plate widths, B1 raw-coordinate with
   lb/ub, B4 at the net-BC plate widths; order 1 and 2; N = 65,536 and
   1,000), and B1 at the wave-confined Fourier widths (128 -> 140 x 6 -> 7,
   order 1, N = 1,000), which take a smaller tile than the plate nets, and
   at each wave configuration's widths (order 1, N = 1,000 and its
   collocation N);
4. serves both quarter-plate models at full width (random weights from a
   numpy seed, through ``params_from_jax``) behind ``FieldServer`` and checks
   every answer against a direct evaluation, the direct evaluation against
   the plain float64 forward, and the launch counts of the kernels;
5. times each forward kernel and its plain version with CUDA events beside
   its bound, at N = 65,536, order 1 (serving) and N = 103,711, order 2
   (the shape training launches), B1 at the wave configurations'
   collocation shapes (order 1), and ``predict_fields`` of both models;
6. holds each backward kernel (B2 raw and with lb/ub, B3b seeded at the
   Fourier64 widths, B5 at the net-BC widths raw and with lb/ub) to its
   plain float64 version on the card, with random cotangents, at N =
   65,536, 1,000 and the
   collocation bank's 103,711 (a partial last tile), order 1 and 2, B2
   and B3b at the wave-confined Fourier widths (order 1, N = 1,000), B2 at
   the 140-, 80- (lb/ub) and 100-wide wave nets and B3b at the
   wave-confined Fourier net (order 1, the collocation N and N = 1,000),
   and requires two runs to give bitwise-equal results;
7. trains the three plate configurations at ``scale=1.0`` (net-BC,
   analytic-BC + Fourier64 with ``trainable="uv.mlp"``, analytic-BC with a
   plain uv MLP): value+grad of the main phase loss on the kernel path
   against the eager float64 path on the card, exactly one forward and one
   backward kernel launch per value+grad, the dist and part losses once,
   and 20 Adam steps whose loss must fall;
8. times each backward kernel at N = 103,711, order 2, and B2/B3b at the
   wave configurations' collocation shapes (order 1), beside its bound and
   its plain version, value+grad per configuration on the kernel path and
   the eager f32 path, and profiles one value+grad per configuration;
9. runs 10 L-BFGS iterations (``train/lbfgs.py::minimize``) of each
   configuration's main phase at ``scale=1.0`` through a counting loss:
   exactly one forward and one backward kernel launch per loss evaluation,
   the final loss below the first; prints iterations/s, line-search
   evaluations per iteration and the optimizer's host time per iteration
   (wall time less the run's value+grads, each timed to its end on the
   device), and times the two-loop product at a full memory of 50 pairs;
10. runs the net-BC ``run_pipeline`` (dist -> part -> uv, 4/4/6 iterations,
   segments of 2) with a checkpoint every segment in a temporary
   directory, cuts a second run after the uv phase's second segment and
   resumes it with ``resume=True``: each phase's loss falls, the resumed uv
   loss equals the uncut one within 1e-6 relative (bitwise or not is
   printed), and the uv phase launched only B4 and B5;
11. builds the wave configurations at ``scale=1.0`` and full width with
   random weights (W1 confined soft 3 -> 140 x 6 -> 7, W2 confined hard-BC +
   Fourier64 with ``B`` trained, W3 infinite 3 -> 80 x 8 -> 7 normalised, W4
   semi-infinite soft 3 -> 100 x 8 -> 7, W5 semi-infinite hard-BC +
   Fourier64, whose model runs the eager jet as in JAX): for W1-W4 the
   value+grad of the main phase on the kernel path against the eager
   float64 path, exactly one forward and one backward launch, value+grad
   timings with a profile, and 10 L-BFGS iterations as in phase 9; for W5
   one value+grad with no kernel launch;
12. runs ``run_time_curriculum`` on wave_infinite at full width (scale 0.1,
   stages of 10 s and 20 s, 4 iterations each) in a temporary directory:
   each stage's loss falls, one B1 and one B2 launch per evaluation, and a
   second call with ``resume=True`` skips both stages and returns the same
   parameters bitwise; then ``python -m pinn_elastodynamics_torch.run``
   trains wave_confined at scale 0.05 in a subprocess, which must exit 0
   and write its metrics, checkpoint and reference pickle;
13. the microbatched million-point loss (BASELINE config #3):
   wave_confined at scale 6.0 padded to 64 (876,736 collocation and
   2,029,248 source points), soft, 3 -> 140 x 6 -> 7 with random weights,
   8 microbatches: loss and gradients against the full-batch kernel path
   and the microbatched eager float64 path, exactly 16 B1 and 8 B2 launches
   per microbatched value+grad (each chunk's forward is recomputed by the
   checkpoint in the backward) and 1 and 1 for the full batch, the peak
   device memory of the three value+grads, value+grad timings in turns, a
   profile, and 10 L-BFGS iterations;
14. the extended-precision endgame on the plate's net-BC (``uv``) and
   analytic + Fourier64 (``uv.mlp``) configurations at scale 1.0: the host
   engine's value+grad (``make_host_phase_vg``) against eager float64 on
   the card, one forward and one backward launch and one device-to-host
   copy per evaluation, its time split into the device value+grad, the
   copy and the host sums; 10 iterations of ``minimize_host``, a 5 + 5
   resumed run that must end bitwise on the straight run, 5 whitened
   iterations (``make_preconditioned_vg``), and ``mixed_precision_phase_fn``
   (float64 loss and gradients against eager float64, then 10 iterations of
   ``minimize`` on the float64 tree);
15. the 3D case (BASELINE config #4) at scale 1.0: ``elastic3d.build``
   (4 -> 100 x 6 -> 12 normalised, N = 225,074) and ``build_mms`` (4 -> 64
   x 5 -> 12, N = 80,000), each as phase 11 runs a wave configuration,
   ``mms_errors`` before and after the MMS iterations, then ``python -m
   pinn_elastodynamics_torch.run --case elastic3d`` in a subprocess.
   Phases 3, 5, 6 and 8 hold and time B1 and B2 at both 3D shapes too;
16. the FEM comparison (``eval/compare.py``) on synthetic ``.mat`` frames
   of 37,811 probes (some on the r = 0.1 hole arc) written in a temporary
   directory: the net-BC plate at full width (81 frames, one B4 launch per
   frame) and wave_confined soft 3 -> 140 x 6 -> 7 (57 frames, one B1
   each).  On frames that hold the eager float64 prediction of the same
   weights every relative L2 of the kernel path stays below 1e-4; on
   frames bumped by a known smooth field, ``compare_frames`` and
   ``hole_edge_errors`` equal the eager float64 ones within 1e-5
   relative.  Then ``python -m pinn_elastodynamics_torch.run --case
   plate_hole --compare-fem --fem-root`` in a subprocess;
17. the inverse problem (``cases/inverse.py``) at full width on frames of a
   plane P-wave at the true E = 2.5, rho = 1: about 118,300 collocation
   points and 20 x 200 acceleration sensors; one value+grad launches B1
   and B2 at order 1 (collocation) and at order 2 (sensors, the 140-wide
   net's new shape), held to eager float64 (loss 1e-5 relative, every
   gradient, log_E and log_rho included, 2e-4 scaled) and bitwise over two
   runs; B1 and B2 at that order-2 shape against their plain float64
   versions and timed, and timed at the collocation's order-1 shape too;
   value+grad timings with a profile; 10 device L-BFGS
   iterations and 10 ``minimize_host`` iterations over
   ``make_host_problem_vg``, with E and rho;
18. adaptive sampling (``geometry/adaptive.py``) on wave_confined soft at
   scale 1.0 (N = 146,149): residual norms against eager float64,
   ``topk_refine`` (k = 4,096) and ``residual_resample`` from a 1,048,576
   point pool in batches of 65,536, forward launches only (16 + 2 B1);
19. ``geometry/native.py``: builds ``libpointgen`` from
   ``native/pointgen.cpp`` on the card's host and holds it to the numpy
   geometry at 1,048,576 points, both timed;
20. data parallelism over the points axis (``parallel/mesh.py``): the
   net-BC plate at scale 1.0 sharded over an NCCL world of one in this
   process (loss within 1e-6 relative and gradients within 2e-4 scaled of
   the mesh-less value+grad, bitwise or not printed; one B4 and one B5
   launch and one reduction of the sums and one of the gradients; both
   timed in turns), then a gloo world of two spawned ranks sharing the
   card, the banks padded to two: the net-BC plate (B4, B5; the
   value+grad, then 3 L-BFGS iterations), analytic + Fourier64 on
   ``uv.mlp`` (B1, B3b) and W1 in 2 microbatches of each rank's shard (B1,
   B2), each rank on half the rows, each value+grad against the mesh-less
   one of the same weights, the ranks' losses, gradients and L-BFGS
   parameters bitwise equal, with the same number of evaluations;

and prints one JSON line describing the kernels, then, only if every phase
passed, the result line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero.  Without a CUDA GPU, or without the package next
to it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

SEED = 20261017
N_BIG = 65536
N_RAGGED = 1000
TOL_FD = 1e-5     # max|err| / max(1, max|ref|) on f and d
TOL_DTT = 5e-5    # the same on dtt
T_SERVE = 2.5
REQUEST_SIZES = (1, 8192, 100_000)
F32_PEAK_FLOPS = 67e12   # H100 SXM, f32 on the CUDA cores (dense)
HBM_BYTES_PER_S = 3.35e12
FOURIER = 64
FOURIER_SCALE = 2.0
TOL_GRAD = 2e-4   # max|err| / max(1, max|ref|): tests/test_fused_vjp.py
TOL_LOSS = 1e-5   # relative, kernel path f32 against eager f64
TOL_RESUME = 1e-6  # relative, resumed against uncut final loss
LBFGS_ITERS = 10
PIPELINE_BUDGET = {"dist": 4, "part": 4, "uv": 6}
ADAM_STEPS = 20
ADAM_LR = 1e-3
N_TRAIN = 103_711  # collocation points of plate_hole.build(scale=1.0)
# The wave-confined hard-BC + Fourier64 net (cases/wave_confined.py), whose
# buffers do not fit in shared memory at the plate nets' forward tiles.
WAVE_DIMS = [2 * 64] + [140] * 6 + [7]
# The kernel shapes of the wave configurations at scale 1.0 (order 1, four
# streams): key -> (widths, collocation N, the domain box the points fill,
# lb/ub of the input normalisation or None, seed of a Fourier64 embedding
# normalised to the confined box).
CONFINED_BOX = ((-15.0, -15.0, 0.0), (15.0, 15.0, 14.0))
# E1 and E2 are the 3D nets (cases/elastic3d.py; twelve outputs, five
# streams).
CUBE_BOX = ((-15.0, -15.0, -15.0, 0.0), (15.0, 15.0, 15.0, 10.0))
MMS_BOX = ((-1.0, -1.0, -1.0, 0.0), (1.0, 1.0, 1.0, 2.0))
WAVE_SHAPES = {
    "W1": ([3] + [140] * 6 + [7], 146_149, CONFINED_BOX, None, False),
    "W2": (WAVE_DIMS, 146_149, CONFINED_BOX, None, True),
    "W3": ([3] + [80] * 8 + [7], 124_830, ((0.0, 0.0, 0.0), (30.0, 30.0, 20.0)),
           ((0.0, 0.0, 0.0), (30.0, 30.0, 20.0)), False),
    "W4": ([3] + [100] * 8 + [7], 150_470,
           ((-15.0, -15.0, 0.0), (15.0, 15.0, 16.0)), None, False),
    "E1": ([4] + [100] * 6 + [12], 225_074, CUBE_BOX, CUBE_BOX, False),
    "E2": ([4] + [64] * 5 + [12], 80_000, MMS_BOX, MMS_BOX, False),
}
WAVE_FOURIER_SCALE = 1.0
# Phase 11: name -> (case module, build kwargs, kernel shape, forward and
# backward kernel of one value+grad; None: the eager jet, as in JAX).
WAVE_CONFIGS = {
    "W1_confined_soft": ("wave_confined", {}, "W1", "fused_mlp_jet",
                         "fused_mlp_jet_bwd"),
    "W2_confined_hard_fourier64": (
        "wave_confined",
        dict(bc="hard", fourier=FOURIER, fourier_scale=WAVE_FOURIER_SCALE),
        "W2", "fused_mlp_jet", "fused_seed_jet_bwd"),
    "W3_infinite": ("wave_infinite", {}, "W3", "fused_mlp_jet",
                    "fused_mlp_jet_bwd"),
    "W4_semi_infinite_soft": ("wave_semi_infinite", {}, "W4", "fused_mlp_jet",
                              "fused_mlp_jet_bwd"),
    "W5_semi_infinite_hard_fourier64": (
        "wave_semi_infinite",
        dict(bc="hard", fourier=FOURIER, fourier_scale=WAVE_FOURIER_SCALE),
        None, None, None),
}
# Phase 12: the curriculum on wave_infinite and the CLI on wave_confined.
CURRICULUM_SCALE = 0.1
CURRICULUM_STAGES = ((10.0, 4), (20.0, 4))   # (max_t, L-BFGS iterations)
CLI_ARGS = ("--case", "wave_confined", "--scale", "0.05", "--maxiter", "uv=4",
            "--segment", "2", "--log-every", "0")
# Phase 13: wave_confined at the scale of BASELINE config #3.
MILLION_SCALE = 6.0
MILLION_PAD = 64
MICROBATCHES = 8
N_MILLION = 876_736        # collocation points, padded
N_MILLION_SRC = 2_029_248  # source points, padded
# Phase 14: name -> (build kwargs, trainable path, tree key, forward and
# backward kernel).
ENDGAME_CONFIGS = {
    "net_bc": ({}, "uv", 0, "fused_composite_jet", "fused_composite_jet_bwd"),
    "analytic_fourier64": (
        dict(bc="analytic", fourier=FOURIER, fourier_scale=FOURIER_SCALE),
        "uv.mlp", 1, "fused_mlp_jet", "fused_seed_jet_bwd"),
}
ENDGAME_ITERS = 10
# Phase 15: name -> (build function of cases/elastic3d.py, kernel shape).
ELASTIC3D_CONFIGS = {"E1_elastic3d": ("build", "E1"),
                     "E2_elastic3d_mms": ("build_mms", "E2")}
CLI_3D_ARGS = ("--case", "elastic3d", "--scale", "0.01", "--maxiter", "uv=4",
               "--segment", "2", "--log-every", "0")
# Phase 16: synthetic FEM frames at the plate's probe grid size (SURVEY.md
# §2 #20), some of them on the r = 0.1 hole arc.
N_PROBES = 37_811
N_RING = 200
# The known smooth field added to the bumped frames, times each field's
# RMS: the kernel path's f32 error moves a relative L2 by about its own
# size over PERTURB, so PERTURB sets how close the two paths' errors are.
PERTURB = 2.0
TOL_FEM = 1e-4     # relative L2 of the kernel path on exact frames
TOL_FEM_MATCH = 1e-5   # kernel path against eager f64, relative
FEM_CLI_ARGS = ("--case", "plate_hole", "--scale", "0.02", "--maxiter",
                "uv=5", "dist=5", "part=5", "--log-every", "0",
                "--compare-fem")
# Phase 17: the inverse problem; sensor frames of a plane P-wave, u =
# A·sin(k(x - c_p·t)), at the true E = 2.5, rho = 1, nu = 0.25.
INVERSE_ACCEL = 2.0
PWAVE_AMP, PWAVE_K = 0.01, 0.5
N_INVERSE_SENSORS = 20 * 200
INVERSE_COLLOCATION = (118_000, 118_700)   # 120,000 LHS less the r = 2 disk
INVERSE_ITERS = 10
# Phase 18: adaptive sampling on wave_confined at scale 1.0.
N_ADAPTIVE = 146_149
ADAPTIVE_K = 4096
N_POOL = 1_048_576
POOL_BATCH = 65_536
# Phase 19: native point generation.
N_NATIVE = 1_048_576
# Phase 20: data parallelism over the points axis.
MESH_SCALE = 1.0
MESH_BACKEND_1 = "nccl"   # the world of one in this process
MESH_WORLD = 2            # the spawned gloo world, every rank on cuda:0
MESH_DEVICE = "cuda:0"
MESH_TIMEOUT_S = 60       # every process group's limit on a collective
MESH_JOIN_S = 240         # the spawned world's limit
MESH_LBFGS_ITERS = 3
MESH_MICROBATCHES = 2
N_MESH_HALF = 51_856      # collocation rows per rank: 103,711 padded to 2
TOL_MESH = 1e-6           # relative, world-1 loss against the mesh-less one
# name -> (case module, build kwargs, trainable path of the main phase or
#          None with microbatches, microbatches, launches per value+grad)
MESH_CONFIGS = {
    "net_bc": ("plate_hole", {}, "uv", 0,
               {"fused_composite_jet": 1, "fused_composite_jet_bwd": 1}),
    "analytic_fourier64": (
        "plate_hole", dict(bc="analytic", fourier=FOURIER,
                           fourier_scale=FOURIER_SCALE), "uv.mlp", 0,
        {"fused_mlp_jet": 1, "fused_seed_jet_bwd": 1}),
    "W1_microbatched": (
        "wave_confined", {}, None, MESH_MICROBATCHES,
        {"fused_mlp_jet": 2 * MESH_MICROBATCHES,
         "fused_mlp_jet_bwd": MESH_MICROBATCHES}),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line(torch) -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        line = proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        line = ""
    return line or f"{torch.cuda.get_device_name(0)}, power limit not read"


def mlp_tree(rng, dims):
    """Random tanh-MLP parameters in the JAX layout (numpy f32)."""
    layers = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = rng.standard_normal((fi, fo)) * np.sqrt(2.0 / (fi + fo))
        b = 0.1 * rng.standard_normal(fo)
        layers.append({"W": w.astype(np.float32), "b": b.astype(np.float32)})
    return layers


def plate_points(rng, n):
    """(n, 2) f32 points of the quarter plate outside the hole."""
    from pinn_elastodynamics_torch.cases.plate_hole import HOLE_R

    pts = np.empty((0, 2), np.float32)
    while pts.shape[0] < n:
        cand = rng.uniform(0.0, 0.5, (2 * n, 2)).astype(np.float32)
        cand = cand[np.hypot(cand[:, 0], cand[:, 1]) > HOLE_R]
        pts = np.concatenate([pts, cand])
    return pts[:n]


def spacetime(rng, n, torch, device):
    xy = plate_points(rng, n)
    t = rng.uniform(0.0, 10.0, (n, 1)).astype(np.float32)
    return torch.as_tensor(np.concatenate([xy, t], 1), device=device)


def box_points(rng, n, box, torch, device):
    """(n, A) f32 points drawn uniformly in the box (lo, hi)."""
    lo, hi = (np.asarray(b, np.float64) for b in box)
    pts = lo + (hi - lo) * rng.uniform(size=(n, lo.size))
    return torch.as_tensor(pts.astype(np.float32), device=device)


def shape_streams(key):
    """Streams of a ``WAVE_SHAPES`` jet at order 1: the value and one
    tangent per input coordinate."""
    return 1 + len(WAVE_SHAPES[key][2][0])


def wave_kernel_inputs(torch, dev, rng, key, n=None):
    """Parameters (tensors), points and the order-1 seed (h0, d) of one wave
    kernel shape (``WAVE_SHAPES``) at n points (its collocation N by
    default)."""
    from pinn_elastodynamics_torch.models.fields import FieldSpec
    from pinn_elastodynamics_torch.models.fourier import FourierMLPFieldModel
    from pinn_elastodynamics_torch.models.mlp import seed_jet
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

    dims, n_full, box, norm, seeded = WAVE_SHAPES[key]
    x = box_points(rng, n or n_full, box, torch, dev)
    params = params_from_jax(mlp_tree(rng, dims), device=dev)
    if seeded:
        embed = FourierMLPFieldModel(
            spec=FieldSpec(), hidden=tuple(dims[1:-1]), n_features=FOURIER,
            normalize=True, lb=CONFINED_BOX[0], ub=CONFINED_BOX[1])
        b = WAVE_FOURIER_SCALE * rng.standard_normal((3, FOURIER))
        h0, d, _ = embed._embed_jet(
            {"B": torch.as_tensor(b, dtype=torch.float32, device=dev)}, x, 1)
    else:
        lb, ub = norm if norm else (None, None)
        h0, d, _ = seed_jet(x, order=1, lb=lb, ub=ub)
    return params, x, h0.contiguous(), d.contiguous()


def to64(tree):
    if isinstance(tree, dict):
        return {k: to64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to64(v) for v in tree]
    return tree.double()


def jet_errors(ker, ref):
    """Scaled and absolute errors of a kernel jet against a reference jet."""
    scaled, worst = {}, 0.0
    for name in ("f", "d", "dtt"):
        r = getattr(ref, name)
        if r is None:
            continue
        k = getattr(ker, name).double()
        err = float((k - r).abs().max())
        scaled[name] = err / max(1.0, float(r.abs().max()))
        worst = max(worst, err)
    return scaled, worst


def check_jet(label, ker, ref):
    scaled, worst = jet_errors(ker, ref)
    log(f"  {label}: " + ", ".join(f"{k} {v:.3e}" for k, v in scaled.items())
        + f" (max abs {worst:.3e})")
    for name, err in scaled.items():
        limit = TOL_DTT if name == "dtt" else TOL_FD
        if not err <= limit:
            raise AssertionError(f"{label}: {name} error {err:.3e} > {limit:.0e}")
    return worst


def flops_per_point(dims, n_streams):
    return 2 * n_streams * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def time_cuda(torch, fn, warmup=3, runs=20):
    """Median milliseconds of ``fn`` by CUDA events."""
    return float(np.median(cuda_times(torch, fn, warmup, runs)))


def cuda_times(torch, fn, warmup=3, runs=20):
    """Milliseconds of each of ``runs`` calls of ``fn`` by CUDA events."""
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
    return times


def time_kernel(torch, name, kern, plain, flops, nbytes, label, runs=20):
    """CUDA-event medians of a kernel's wrapper and of its plain f32
    version, beside the bound of the work: the larger of its operations
    over the f32 peak and its bytes over the memory rate."""
    ms = time_cuda(torch, kern, runs=runs)
    plain_ms = time_cuda(torch, plain, runs=runs)
    op_ms = flops / F32_PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {name} {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(op_ms, byte_ms):.4f} ms ({flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes"}


def n_params(tree):
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(tree))


def device_breakdown(torch, fn, top=4):
    """Profile one call of ``fn``: wall seconds, device-busy seconds and the
    kernels with the most device time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us * 1e-6, evt.count, evt.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows[:top]


def bwd_flops_per_point(dims, n_streams):
    """FLOPs per point that the backward of one MLP jet needs: per hidden
    layer the forward once (2S per weight), the weight gradient and the
    input cotangent (2S each); the head's weight gradient and input
    cotangent.  The kernel's recompute of the non-value pre-activations in
    the reverse sweep saves memory, not work the function needs, so it is
    not counted."""
    s = n_streams
    widths = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return 6 * s * sum(widths[:-1]) + 4 * s * widths[-1]


def max_scaled(got, ref):
    """max|got - ref| / max(1, max|ref|) and max|got - ref|."""
    err = float((got.double() - ref).abs().max())
    return err / max(1.0, float(ref.abs().max())), err


def bitwise_equal(a, b):
    """Two trees (or tensors) of results are bitwise equal."""
    import torch

    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def check_grads(label, got, ref, limit=TOL_GRAD):
    """Every leaf of a gradient tree against its float64 reference."""
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    worst_scaled = worst_abs = 0.0
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        scaled, err = max_scaled(g, r)
        worst_scaled, worst_abs = max(worst_scaled, scaled), max(worst_abs, err)
    if not worst_scaled <= limit:
        raise AssertionError(f"{label}: gradient error {worst_scaled:.3e} > "
                             f"{limit:.0e}")
    return worst_scaled, worst_abs


def backward_checks(torch, dev, rng, trees, fourier, wave):
    """Phase 6: each backward kernel against its plain float64 version,
    twice for bitwise determinism.  Returns the largest absolute error per
    kernel."""
    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.models.mlp import seed_jet

    net_p, ana_p, raw_p = trees
    net_p64, ana_p64, raw_p64 = to64(net_p), to64(ana_p), to64(raw_p)
    max_err = dict.fromkeys(fv.LAUNCHES, 0.0)

    def run(name, label, kernel, plain):
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        if not bitwise_equal(first, second):
            raise AssertionError(f"{label}: two runs differ")
        (grads, dx), (ref_grads, ref_dx) = first, plain()
        g_scaled, g_abs = check_grads(label, grads, ref_grads)
        x_scaled, x_abs = max_scaled(dx, ref_dx)
        log(f"  {label}: grads {g_scaled:.3e}, dx {x_scaled:.3e} "
            f"(max abs {max(g_abs, x_abs):.3e}), two runs bitwise equal")
        if not x_scaled <= TOL_GRAD:
            raise AssertionError(f"{label}: dx error {x_scaled:.3e}")
        max_err[name] = max(max_err[name], g_abs, x_abs)

    for n in (N_BIG, N_RAGGED, N_TRAIN):
        x = spacetime(rng, n, torch, dev)
        x64 = x.double()
        for order in (1, 2):
            s = 3 + order
            cot = torch.as_tensor(rng.standard_normal((s, n, 5)),
                                  dtype=torch.float32, device=dev)
            cot64 = cot.double()
            for lb, ub in ((None, None), (plate_hole.LB, plate_hole.UB)):
                h0, d, dtt = (t if t is None else t.contiguous()
                              for t in seed_jet(x, order=order, lb=lb, ub=ub))
                seed64 = [None if t is None else t.double()
                          for t in (h0, d, dtt)]
                run("fused_mlp_jet_bwd",
                    f"B2 {'lb/ub' if lb else 'raw'} n={n} order={order}",
                    lambda: fv.fused_mlp_jet_bwd(raw_p, h0, d, dtt, cot,
                                                 full_dx=False),
                    lambda: (lambda g, ds: (g, ds[0]))(
                        *fv.mlp_jet_bwd_reference(raw_p64, *seed64, cot64)))
            h0, d, dtt = fourier._embed_jet(ana_p["uv"], x, order)
            seed64 = [None if t is None else t.double() for t in (h0, d, dtt)]
            run("fused_seed_jet_bwd",
                f"B3b seeded Fourier{FOURIER} n={n} order={order}",
                lambda: fv.fused_mlp_jet_bwd(ana_p["uv"]["mlp"], h0, d, dtt,
                                             cot, full_dx=True),
                lambda: fv.mlp_jet_bwd_reference(ana_p64["uv"]["mlp"],
                                                 *seed64, cot64))
            for lb, ub in ((None, None), (plate_hole.LB, plate_hole.UB)):
                run("fused_composite_jet_bwd",
                    f"B5 composite {'lb/ub' if lb else 'raw'} n={n} "
                    f"order={order}",
                    lambda: fv.fused_composite_jet_bwd(net_p, x, cot,
                                                       order=order, lb=lb,
                                                       ub=ub),
                    lambda: fv.composite_jet_bwd_reference(
                        net_p64, x64, cot64, order=order, lb=lb, ub=ub))

    # The wave-confined Fourier widths: a 16-point tile, one weight buffer.
    wrng = np.random.default_rng(SEED + 3)
    x = spacetime(wrng, N_RAGGED, torch, dev)
    h0, d, _ = fourier._embed_jet(ana_p["uv"], x, 1)
    cot = torch.as_tensor(wrng.standard_normal((4, N_RAGGED, WAVE_DIMS[-1])),
                          dtype=torch.float32, device=dev)
    wave64 = to64(wave)
    ref = fv.mlp_jet_bwd_reference(wave64, h0.double(), d.double(), None,
                                   cot.double())
    run("fused_mlp_jet_bwd", f"B2 wave-confined widths n={N_RAGGED} order=1",
        lambda: fv.fused_mlp_jet_bwd(wave, h0, d, None, cot, full_dx=False),
        lambda: (ref[0], ref[1][0]))
    run("fused_seed_jet_bwd", f"B3b wave-confined widths n={N_RAGGED} order=1",
        lambda: fv.fused_mlp_jet_bwd(wave, h0, d, None, cot, full_dx=True),
        lambda: ref)

    # The wave configurations' shapes: N = 1,000 and the collocation N (a
    # partial last tile); W2 at N = 1,000 is the net held just above.
    for key in WAVE_SHAPES:
        seeded = WAVE_SHAPES[key][4]
        name = "fused_seed_jet_bwd" if seeded else "fused_mlp_jet_bwd"
        for n in ((None,) if seeded else (N_RAGGED, None)):
            params, x, h0, d = wave_kernel_inputs(torch, dev, wrng, key, n)
            n_pts = x.shape[0]
            cot = torch.as_tensor(
                wrng.standard_normal((shape_streams(key), n_pts,
                                      WAVE_SHAPES[key][0][-1])),
                dtype=torch.float32, device=dev)
            ref = fv.mlp_jet_bwd_reference(to64(params), h0.double(),
                                           d.double(), None, cot.double())
            run(name, f"{'B3b' if seeded else 'B2'} {key} widths "
                f"{WAVE_SHAPES[key][0][1]} n={n_pts} order=1",
                lambda: fv.fused_mlp_jet_bwd(params, h0, d, None, cot,
                                             full_dx=seeded),
                lambda: ref if seeded else (ref[0], ref[1][0]))
            del ref
    return max_err


# name -> (build kwargs, trainable path of the main phase, tree key,
#          forward kernel, backward kernel)
TRAIN_CONFIGS = {
    "net_bc": ({}, "uv", 0, "fused_composite_jet", "fused_composite_jet_bwd"),
    "analytic_fourier64": (
        dict(bc="analytic", fourier=FOURIER, fourier_scale=FOURIER_SCALE),
        "uv.mlp", 1, "fused_mlp_jet", "fused_seed_jet_bwd"),
    "analytic_plain": (dict(bc="analytic"), "uv", 2, "fused_mlp_jet",
                       "fused_mlp_jet_bwd"),
}


def eager_f64_case(case):
    """The same case with float64 banks and every jet on the eager path."""
    from pinn_elastodynamics_torch.banks import PointBank

    banks64 = {k: PointBank(b.xyt.double(), b.mask.double(),
                            {v: t.double() for v, t in b.values.items()})
               for k, b in case.banks.items()}
    return dataclasses.replace(case, model=eager_copy(case.model),
                               banks=banks64)


def counted_value_and_grad(torch, name, fn, sub, want):
    """One value+grad of ``fn`` at ``sub`` after a warm-up, with the kernel
    launches it made and the peak device memory it took.  Raises unless
    the launches are ``want`` (kernel -> count; every other kernel 0)."""
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train.step import value_and_grad

    value_and_grad(fn, sub)   # warm-up
    torch.cuda.synchronize()
    fj.reset_launches()
    fv.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = value_and_grad(fn, sub)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {**fj.LAUNCHES, **fv.LAUNCHES}
    expected = dict.fromkeys(launches, 0)
    expected.update(want)
    log(f"  {name}: loss {float(loss):.9g}, launches {launches}, peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if launches != expected or not bool(torch.isfinite(loss)):
        raise AssertionError(f"{name}: launches {launches} != {expected}, "
                             f"loss {float(loss)}")
    return loss, grads, launches, peak


def check_against_f64(name, case, phase, params, loss, grads):
    """A kernel-path value+grad of a phase loss against the eager float64
    value+grad on the same device: the loss within TOL_LOSS relative, the
    gradients within TOL_GRAD scaled."""
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.train.step import value_and_grad

    fn64, sub64, _ = _phase_loss_fn(eager_f64_case(case), phase,
                                    to64(params))
    loss64, grads64 = value_and_grad(fn64, sub64)
    rel = abs(float(loss) - float(loss64)) / abs(float(loss64))
    g_scaled, g_abs = check_grads(f"{name} value+grad", grads, grads64)
    log(f"  {name}: loss {float(loss):.9g} (f64 {float(loss64):.9g}, "
        f"rel {rel:.2e}), gradients {g_scaled:.3e} (max abs {g_abs:.3e})")
    if not rel <= TOL_LOSS:
        raise AssertionError(f"{name}: loss differs by {rel:.2e}")


def training_checks(torch, dev, trees):
    """Phase 7: value+grad of each configuration's main phase on the kernel
    path against eager float64, launch counts, dist/part losses, Adam.
    Returns per configuration (case, phase loss, subtree, launches)."""
    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.train.adam import Adam
    from pinn_elastodynamics_torch.train.step import (
        make_grad_step,
        value_and_grad,
    )

    out = {}
    for name, (kw, trainable, key, fwd, bwd) in TRAIN_CONFIGS.items():
        t0 = time.perf_counter()
        case = plate_hole.build(scale=1.0, device=dev, **kw)
        assert case.banks["collocation"].n_total == N_TRAIN
        params = trees[key]
        phase = dataclasses.replace(case.phases[-1], trainable=trainable)
        fn, sub, _ = _phase_loss_fn(case, phase, params)
        loss, grads, launches, _ = counted_value_and_grad(
            torch, name, fn, sub, {fwd: 1, bwd: 1})
        check_against_f64(name, case, phase, params, loss, grads)

        for pre in case.phases[:-1]:   # dist, part: eager jets, as in JAX
            pfn, psub, _ = _phase_loss_fn(case, pre, params)
            ploss, pgrads = value_and_grad(pfn, psub)
            if not bool(torch.isfinite(ploss)):
                raise AssertionError(f"{name}: {pre.name} loss {ploss}")
            log(f"  {name}: {pre.name} phase loss {float(ploss):.6g}")

        opt = Adam(ADAM_LR)
        step = make_grad_step(case.model, case.loss, case.material, opt)
        p, state, losses = params, opt.init(params), []
        t1 = time.perf_counter()
        for _ in range(ADAM_STEPS):
            p, state, l, _ = step(p, state, case.banks)
            losses.append(float(l))
        adam_s = time.perf_counter() - t1
        log(f"  {name}: {ADAM_STEPS} Adam steps, loss {losses[0]:.6g} -> "
            f"{losses[-1]:.6g}, {1e3 * adam_s / ADAM_STEPS:.2f} ms/step")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: Adam losses {losses}")
        out[name] = dict(case=case, fn=fn, sub=sub, phase=phase,
                         params=params, launches=launches)
        log(f"  {name}: {time.perf_counter() - t0:.2f} s")
    return out


def backward_timings(torch, dev, rng, trees, fourier, trained, bwd_err,
                     launches):
    """Phase 8: each backward kernel and its plain f32 version by CUDA
    events on the collocation bank (N = 103,711, order 2) and B2/B3b at the
    wave configurations' collocation shapes (order 1), beside their bounds;
    value+grad per configuration, kernel path and eager f32; one profiled
    value+grad per configuration."""
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.models.mlp import seed_jet

    net_p, ana_p, raw_p = trees
    x = trained["net_bc"]["case"].banks["collocation"].xyt
    n = x.shape[0]
    cot = torch.as_tensor(rng.standard_normal((5, n, 5)), dtype=torch.float32,
                          device=dev)
    h0, d, dtt = (t.contiguous() for t in seed_jet(x, order=2))
    fh, fd, ftt = fourier._embed_jet(ana_p["uv"], x, 2)
    uv_dims = [3] + [70] * 8 + [5]
    small_dims = [3] + [20] * 4 + [5]
    four_dims = [2 * FOURIER] + [70] * 8 + [5]

    # Bytes: every input read once, every output written once (f32).
    timed = {
        "fused_mlp_jet_bwd": (
            lambda: fv.fused_mlp_jet_bwd(raw_p, h0, d, dtt, cot,
                                         full_dx=False),
            lambda: fv.mlp_jet_bwd_reference(raw_p, h0, d, dtt, cot),
            bwd_flops_per_point(uv_dims, 5) * n,
            4 * (5 * n * 3 + cot.numel() + 2 * n_params(raw_p) + n * 3),
            "pinn_elastodynamics_tpu/kernels/fused_jet_vjp.py:178"),
        "fused_seed_jet_bwd": (
            lambda: fv.fused_mlp_jet_bwd(ana_p["uv"]["mlp"], fh, fd, ftt, cot,
                                         full_dx=True),
            lambda: fv.mlp_jet_bwd_reference(ana_p["uv"]["mlp"], fh, fd, ftt,
                                             cot),
            bwd_flops_per_point(four_dims, 5) * n,
            4 * (2 * 5 * n * 2 * FOURIER + cot.numel()
                 + 2 * n_params(ana_p["uv"]["mlp"])),
            "pinn_elastodynamics_tpu/kernels/fused_jet_vjp.py:342"),
        "fused_composite_jet_bwd": (
            lambda: fv.fused_composite_jet_bwd(net_p, x, cot, order=2),
            lambda: fv.composite_jet_bwd_reference(net_p, x, cot, order=2),
            (bwd_flops_per_point(uv_dims, 5)
             + 2 * bwd_flops_per_point(small_dims, 5)
             + 2 * 5 * (70 * 5 + 20 * 5)) * n,   # + the uv and dist heads
            4 * (2 * x.numel() + cot.numel() + 2 * n_params(net_p)),
            "pinn_elastodynamics_tpu/kernels/fused_jet_vjp.py:575"),
    }
    kernels = []
    for name, (kern, plain, flops, nbytes, replaces) in timed.items():
        times = time_kernel(torch, name, kern, plain, flops, nbytes,
                            f"n={n} order=2", runs=10)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pinn_elastodynamics_torch/kernels/csrc/fused_jet_vjp.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": bwd_err[name], **times, "library_ms": None,
        })

    # B2 and B3b at the wave configurations' collocation shapes (order 1).
    wrng = np.random.default_rng(SEED + 6)
    for key, (dims, n_w, _, _, seeded) in WAVE_SHAPES.items():
        params, _, wh, wd = wave_kernel_inputs(torch, dev, wrng, key)
        s_w = shape_streams(key)
        wcot = torch.as_tensor(wrng.standard_normal((s_w, n_w, dims[-1])),
                               dtype=torch.float32, device=dev)
        name = "fused_seed_jet_bwd" if seeded else "fused_mlp_jet_bwd"
        seed_elems = wh.numel() + wd.numel()
        nbytes = 4 * (seed_elems + wcot.numel() + 2 * n_params(params)
                      + (seed_elems if seeded else wh.numel()))
        times = time_kernel(
            torch, name,
            lambda: fv.fused_mlp_jet_bwd(params, wh, wd, None, wcot,
                                         full_dx=seeded),
            lambda: fv.mlp_jet_bwd_reference(params, wh, wd, None, wcot),
            bwd_flops_per_point(dims, s_w) * n_w, nbytes,
            f"{key} n={n_w} order=1", runs=10)
        entry = next(k for k in kernels if k["name"] == name)
        entry.setdefault("wave_shapes", {})[key] = times

    for name, t in trained.items():
        value_and_grad_timings(torch, name, t["case"], t["phase"],
                               t["params"], t["fn"], t["sub"])
    return kernels


def turns(torch, fns, warmup=3, runs=5, n_turns=3):
    """CUDA-event milliseconds of each of ``fns`` (name -> callable) in
    ``n_turns`` turns of ``runs``, so that a slow spell of the host falls on
    all of them; name -> list of times."""
    out = {k: [] for k in fns}
    for _ in range(n_turns):
        for k, fn in fns.items():
            out[k] += cuda_times(torch, fn, warmup=warmup, runs=runs)
    return out


def profile_line(torch, label, fn):
    wall, busy, rows = device_breakdown(torch, fn, top=6)
    log(f"  profiled {label}: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    for sec_k, count, key in rows:
        log(f"    {sec_k:.5f} s  x{count}  {key[:90]}")


def value_and_grad_timings(torch, name, case, phase, params, fn, sub):
    """Value+grad of a phase loss by CUDA events, the kernel path and the
    eager f32 path in three turns of 5 (median and range of 15), and one
    profiled value+grad of the kernel path.  Returns the kernel path's
    median ms."""
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.train.step import value_and_grad

    eager_case = dataclasses.replace(case, model=eager_copy(case.model))
    efn, esub, _ = _phase_loss_fn(eager_case, phase, params)
    times = turns(torch, {"kernel": lambda: value_and_grad(fn, sub),
                          "eager": lambda: value_and_grad(efn, esub)})
    ker, eag = times["kernel"], times["eager"]
    log(f"  value+grad {name}: kernel path {np.median(ker):.3f} ms "
        f"[{min(ker):.3f}, {max(ker):.3f}], eager f32 {np.median(eag):.3f} "
        f"ms [{min(eag):.3f}, {max(eag):.3f}] (CUDA events, median and "
        f"range of 15, in three turns)")
    profile_line(torch, f"value+grad {name}",
                 lambda: value_and_grad(fn, sub))
    return float(np.median(ker))


def host_ms(torch, fn, runs=5):
    """Median host-clock milliseconds of ``fn`` ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return float(np.median(times))


def add_launches(total, launches):
    """Launch counts summed key by key (``total`` may be None)."""
    if total is None:
        return dict(launches)
    return {k: total[k] + launches[k] for k in total}


def lbfgs_run(torch, name, fn, sub, ftol, per_eval):
    """LBFGS_ITERS L-BFGS iterations of the phase loss ``fn`` from ``sub``
    through a counting loss: exactly ``per_eval[k]`` launches of kernel k
    per evaluation and none of any other, the final loss below the first;
    prints iterations/s, line-search evaluations per iteration and the
    optimizer's host time per iteration (wall less the run's value+grads,
    each timed to its end).  Returns the launches and the result."""
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train import lbfgs

    plain_vg = lbfgs.value_and_grad
    eval_ms, losses = [], []

    def timed_vg(*args, **kwargs):
        """The optimizer's value+grad, timed to its end on the device."""
        start = time.perf_counter()
        out = plain_vg(*args, **kwargs)
        torch.cuda.synchronize()
        eval_ms.append(1e3 * (time.perf_counter() - start))
        return out

    def counted(p):
        loss = fn(p)
        losses.append(loss.detach())
        return loss

    fj.reset_launches()
    fv.reset_launches()
    torch.cuda.synchronize()
    lbfgs.value_and_grad = timed_vg
    try:
        start = time.perf_counter()
        res = lbfgs.minimize(counted, sub, maxiter=LBFGS_ITERS, ftol=ftol,
                             segment=LBFGS_ITERS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    finally:
        lbfgs.value_and_grad = plain_vg
    launches = {**fj.LAUNCHES, **fv.LAUNCHES}
    evals = len(losses)
    want = dict.fromkeys(launches, 0)
    want.update({k: per * evals for k, per in per_eval.items()})
    first, final = float(losses[0]), float(res.final_loss)
    n = res.n_iters
    log(f"  {name}: {n} iterations, {evals} evaluations, loss "
        f"{first:.6g} -> {final:.6g}; {1e3 * n / wall_ms:.3f} it/s, "
        f"{(evals - 1) / n:.2f} line-search evaluations per iteration, "
        f"value+grad {np.median(eval_ms):.3f} ms [{min(eval_ms):.3f}, "
        f"{max(eval_ms):.3f}] (host clock, median and range of "
        f"{len(eval_ms)}), optimizer host time "
        f"{(wall_ms - sum(eval_ms)) / n:.3f} ms per iteration; "
        f"launches {launches}")
    if n != LBFGS_ITERS or len(eval_ms) != evals or launches != want:
        raise AssertionError(f"{name}: {n} iterations, launches "
                             f"{launches} != {want}")
    if not (np.isfinite(final) and final < first):
        raise AssertionError(f"{name}: L-BFGS loss {first} -> {final}")
    return launches, res


def lbfgs_checks(torch, trained):
    """Phase 9: L-BFGS on each configuration's main phase.  Returns the
    kernel launches of the three runs."""
    from pinn_elastodynamics_torch.train import lbfgs

    total = None
    for name, t in trained.items():
        fwd, bwd = TRAIN_CONFIGS[name][3:]
        launches, _ = lbfgs_run(torch, name, t["fn"], t["sub"],
                                t["phase"].ftol, {fwd: 1, bwd: 1})
        total = add_launches(total, launches)

    # The two-loop product at a full memory (50 pairs) at net-BC's uv size.
    net = trained["net_bc"]
    layout = lbfgs._Flat(net["sub"])
    x = layout.flatten(net["sub"])
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    state = lbfgs._lbfgs_init(x, 50)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=x.device)
    state.update(count=60, params=x + 1e-3 * rand(x.numel()),
                 updates=rand(x.numel()),
                 diff_params_memory=rand(50, x.numel()),
                 diff_updates_memory=rand(50, x.numel()),
                 weights_memory=rand(50).abs() + 1.0)
    g = rand(x.numel())
    ms = host_ms(torch, lambda: lbfgs._lbfgs_direction(g, state, x), runs=10)
    log(f"  two-loop product, memory 50 x {x.numel()}: {ms:.3f} ms "
        f"(host clock, median of 10)")
    return total


def pipeline_checks(torch, dev, params):
    """Phase 10: net-BC run_pipeline, cut after the uv phase's second
    segment and resumed.  Returns the kernel launches of the uncut run."""
    import os
    import tempfile

    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.cases.base import run_pipeline
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train.checkpoint import load_checkpoint

    case = plate_hole.build(scale=1.0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fj.reset_launches()
        fv.reset_launches()
        start = time.perf_counter()
        _, uncut = run_pipeline(case, params, maxiter_override=PIPELINE_BUDGET,
                                segment=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        for name, res in uncut.items():
            hist = res.loss_history
            log(f"  {name}: {res.n_iters} iterations, loss {hist[0]:.6g} -> "
                f"{hist[-1]:.6g}")
            if not (res.n_iters == PIPELINE_BUDGET[name]
                    and np.all(np.isfinite(hist)) and hist[-1] < hist[0]):
                raise AssertionError(f"{name}: history {hist}")
        log(f"  uncut pipeline {wall:.2f} s, launches {launches}")
        # dist and part run eager jets; uv one B4 and one B5 per evaluation.
        uv_evals = launches["fused_composite_jet"]
        want = dict.fromkeys(launches, 0)
        want.update(fused_composite_jet=uv_evals,
                    fused_composite_jet_bwd=uv_evals)
        if launches != want or uv_evals < PIPELINE_BUDGET["uv"]:
            raise AssertionError(f"pipeline launches {launches}")

        live = os.path.join(tmp, "live.ckpt")
        cut_budget = dict(PIPELINE_BUDGET, uv=4)
        run_pipeline(case, params, maxiter_override=cut_budget, segment=2,
                     checkpoint_path=live, checkpoint_every_segments=1)
        saved = load_checkpoint(live)
        if saved["phase"] != "uv" or saved["iters"] != 4:
            raise AssertionError(f"checkpoint at {saved['phase']}, "
                                 f"{saved['iters']} iterations")
        _, resumed = run_pipeline(case, None, maxiter_override=PIPELINE_BUDGET,
                                  segment=2, checkpoint_path=live,
                                  checkpoint_every_segments=1, resume=True)
    if sorted(resumed) != ["uv"] or resumed["uv"].n_iters != 2:
        raise AssertionError(f"resumed phases {sorted(resumed)}")
    got, want_loss = (float(resumed["uv"].final_loss),
                      float(uncut["uv"].final_loss))
    rel = abs(got - want_loss) / abs(want_loss)
    log(f"  resumed uv loss {got:.9g}, uncut {want_loss:.9g} (rel {rel:.2e}, "
        f"bitwise equal: {got == want_loss})")
    if not rel <= TOL_RESUME:
        raise AssertionError(f"resumed loss differs by {rel:.2e}")
    return launches


def wave_params(rng, model):
    """Random parameters of a wave model in the JAX layout (numpy f32): an
    MLP, a Fourier net {'B', 'mlp'}, either under 'uv' for a closed-form
    hard-BC composite."""
    net = getattr(model, "uv_model", model)
    tree = mlp_tree(rng, list(net.layers))
    if hasattr(net, "n_features"):
        b = net.feature_scale * rng.standard_normal((3, net.n_features))
        tree = {"B": b.astype(np.float32), "mlp": tree}
    return {"uv": tree} if net is not model else tree


def drive_config(torch, name, case, params, per_eval):
    """Phase 11's checks of one configuration's only phase (every parameter
    trained): one value+grad with exactly ``per_eval`` launches; unless
    that is empty (an eager model), the value+grad against eager float64
    with its peak device memory, value+grad timings with a profile, and
    LBFGS_ITERS L-BFGS iterations.  Returns the launches and the L-BFGS
    result (None for an eager model)."""
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn

    n_col = case.banks["collocation"].n_total
    (phase,) = case.phases
    fn, sub, _ = _phase_loss_fn(case, phase, params)
    loss, grads, launches, _ = counted_value_and_grad(
        torch, f"{name}: N = {n_col}", fn, sub, per_eval)
    if not per_eval:   # the eager Fourier model kept from JAX
        return launches, None
    torch.cuda.reset_peak_memory_stats()
    check_against_f64(name, case, phase, params, loss, grads)
    log(f"  {name}: float64 check at scale 1.0, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del grads
    value_and_grad_timings(torch, name, case, phase, params, fn, sub)
    more, res = lbfgs_run(torch, name, fn, sub, phase.ftol, per_eval)
    return add_launches(launches, more), res


def wave_checks(torch, dev):
    """Phase 11: the wave configurations at scale 1.0 and full width with
    random weights.  W1-W4: value+grad of the main phase (every parameter
    trained) on the kernel path against eager float64, one forward and one
    backward launch, value+grad timings with a profile, and 10 L-BFGS
    iterations; W5 (eager Fourier model, as in JAX): one value+grad with no
    launch.  Returns the kernel launches of the counted runs."""
    import importlib

    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

    rng = np.random.default_rng(SEED + 7)
    total = None
    for name, (mod_name, kw, key, fwd, bwd) in WAVE_CONFIGS.items():
        t0 = time.perf_counter()
        mod = importlib.import_module(
            f"pinn_elastodynamics_torch.cases.{mod_name}")
        case = mod.build(scale=1.0, device=dev, **kw)
        n_col = case.banks["collocation"].n_total
        if key is not None and n_col != WAVE_SHAPES[key][1]:
            raise AssertionError(f"{name}: {n_col} collocation points")
        params = params_from_jax(wave_params(rng, case.model), device=dev)
        launches, _ = drive_config(torch, name, case, params,
                                   {} if fwd is None else {fwd: 1, bwd: 1})
        total = add_launches(total, launches)
        del case, params
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.2f} s")
    return total


def curriculum_checks(torch, dev):
    """Phase 12: ``run_time_curriculum`` on wave_infinite at full width
    (scale CURRICULUM_SCALE, stages 10 s and 20 s) in a temporary directory:
    each stage's loss falls, one B1 and one B2 launch per evaluation, and a
    second call with ``resume=True`` skips both stages and returns the same
    parameters bitwise; then the CLI trains wave_confined in a subprocess.
    Returns the kernel launches of the first curriculum call."""
    import os
    import tempfile

    from pinn_elastodynamics_torch.cases import wave_infinite
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train import lbfgs
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
    from pinn_elastodynamics_torch.train.curriculum import (
        Stage,
        run_time_curriculum,
    )

    stages = [Stage(max_t=t, maxiter=it, warmup_iters=2, warmup_segment=2)
              for t, it in CURRICULUM_STAGES]
    params = params_from_jax(
        wave_params(np.random.default_rng(SEED + 8),
                    wave_infinite.build_model()), device=dev)
    plain_vg = lbfgs.value_and_grad
    losses, stage_ends = [], []

    def recorded_vg(*args, **kwargs):
        out = plain_vg(*args, **kwargs)
        losses.append(float(out[0]))
        return out

    class StageEnds:
        """A logger that notes how many evaluations each stage ended at."""

        def log(self, record):
            stage_ends.append(len(losses))

    kw = dict(builder_kwargs=dict(scale=CURRICULUM_SCALE), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fj.reset_launches()
        fv.reset_launches()
        lbfgs.value_and_grad = recorded_vg
        try:
            start = time.perf_counter()
            first, summaries = run_time_curriculum(
                wave_infinite.build, stages, params=params,
                checkpoint_dir=tmp, logger=StageEnds(), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            lbfgs.value_and_grad = plain_vg
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        begin = 0
        for summary, end in zip(summaries, stage_ends, strict=True):
            seed_loss, final = losses[begin], summary["final_loss"]
            log(f"  stage {summary['stage']} (T = {summary['max_t']:g}): "
                f"{summary['iters']} iterations, {end - begin} evaluations, "
                f"loss {seed_loss:.6g} -> {final:.6g}")
            if not (summary["iters"] == stages[summary["stage"]].maxiter
                    and np.isfinite(final) and final < seed_loss):
                raise AssertionError(f"curriculum stage {summary}")
            begin = end
        want = dict.fromkeys(launches, 0)
        want["fused_mlp_jet"] = want["fused_mlp_jet_bwd"] = len(losses)
        log(f"  curriculum {wall:.2f} s, {len(losses)} evaluations, launches "
            f"{launches}")
        if launches != want:
            raise AssertionError(f"curriculum launches {launches} != {want}")
        again, resumed = run_time_curriculum(
            wave_infinite.build, stages, checkpoint_dir=tmp, resume=True, **kw)
        same = bitwise_equal(first, again)
        log(f"  resumed curriculum: stages skipped "
            f"{[bool(r.get('resumed')) for r in resumed]}, parameters "
            f"bitwise equal: {same}")
        if not (same and all(r.get("resumed") for r in resumed)):
            raise AssertionError("the resumed curriculum differs")

        out = os.path.join(tmp, "cli")
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pinn_elastodynamics_torch.run", *CLI_ARGS,
             "--out", out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = {e["event"]: e for e in map(json.loads, f)}
        comps = events["train_done"]["components"]
        log(f"  CLI {' '.join(CLI_ARGS)}: exit 0 in "
            f"{time.perf_counter() - start:.2f} s, start {events['start']}, "
            f"phase_end {events['phase_end']}, components {comps}")
        written = [os.path.exists(os.path.join(out, f))
                   for f in ("elastic_wave_confined_uv.ckpt",
                             "elastic_wave_confined_uv.pickle")]
        if not ("cuda" in events["start"]["devices"][0] and all(written)
                and np.all(np.isfinite(list(comps.values())))):
            raise AssertionError(f"CLI run: {events}, files {written}")
    return launches


def scaled_loss_error(label, loss, ref, limit=TOL_LOSS):
    rel = abs(float(loss) - float(ref)) / abs(float(ref))
    if not rel <= limit:
        raise AssertionError(f"{label}: loss differs by {rel:.2e}")
    return rel


def million_checks(torch, dev):
    """Phase 13: the microbatched million-point loss (BASELINE config #3).
    Returns the kernel launches of the counted runs."""
    from pinn_elastodynamics_torch.cases import wave_confined
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
    from pinn_elastodynamics_torch.train.step import (
        make_loss_fn,
        make_microbatched_loss_fn,
        value_and_grad,
    )

    case = wave_confined.build(scale=MILLION_SCALE,
                               pad_to_multiple_of=MILLION_PAD, device=dev)
    sizes = {k: b.n_total for k, b in case.banks.items()}
    log(f"  banks {sizes}, {MICROBATCHES} microbatches of "
        f"{sizes['collocation'] // MICROBATCHES} points")
    if (sizes["collocation"], sizes["src"]) != (N_MILLION, N_MILLION_SRC):
        raise AssertionError(f"million-point banks {sizes}")
    params = params_from_jax(
        wave_params(np.random.default_rng(SEED + 9), case.model), device=dev)
    micro = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                      num_microbatches=MICROBATCHES)
    full = make_loss_fn(case.model, case.loss, case.material)
    mfn = lambda p: micro(p, case.banks)[0]
    ffn = lambda p: full(p, case.banks)[0]

    loss_m, grads_m, launches, peak_m = counted_value_and_grad(
        torch, "microbatched value+grad", mfn, params,
        {"fused_mlp_jet": 2 * MICROBATCHES,
         "fused_mlp_jet_bwd": MICROBATCHES})
    total = dict(launches)
    loss_f, grads_f, launches, peak_f = counted_value_and_grad(
        torch, "full-batch value+grad", ffn, params,
        {"fused_mlp_jet": 1, "fused_mlp_jet_bwd": 1})
    total = add_launches(total, launches)
    rel = scaled_loss_error("microbatched against full batch", loss_m, loss_f)
    g_scaled, g_abs = check_grads("microbatched against full batch",
                                  grads_m, grads_f)
    log(f"  microbatched against full batch: loss rel {rel:.2e}, gradients "
        f"{g_scaled:.3e} (max abs {g_abs:.3e})")
    del grads_f

    # Eager float64, microbatched: the full batch would need about 94 GB.
    case64 = eager_f64_case(case)
    micro64 = make_microbatched_loss_fn(case64.model, case64.loss,
                                        case64.material,
                                        num_microbatches=MICROBATCHES)
    torch.cuda.reset_peak_memory_stats()
    loss64, grads64 = value_and_grad(lambda p: micro64(p, case64.banks)[0],
                                     to64(params))
    torch.cuda.synchronize()
    peak64 = torch.cuda.max_memory_allocated()
    for label, loss in (("microbatched", loss_m), ("full batch", loss_f)):
        rel = scaled_loss_error(f"{label} against f64", loss, loss64)
        log(f"  {label} kernel path {float(loss):.9g} against microbatched "
            f"eager f64 {float(loss64):.9g} ({MICROBATCHES} microbatches): "
            f"rel {rel:.2e}")
    g_scaled, g_abs = check_grads("microbatched against f64", grads_m,
                                  grads64)
    log(f"  microbatched gradients against f64: {g_scaled:.3e} (max abs "
        f"{g_abs:.3e}); peak device memory: microbatched "
        f"{peak_m / 2**30:.2f} GiB, full batch {peak_f / 2**30:.2f} GiB, "
        f"eager f64 with {MICROBATCHES} microbatches {peak64 / 2**30:.2f} GiB")
    del case64, micro64, grads64, grads_m
    torch.cuda.empty_cache()

    times = turns(torch, {"micro": lambda: value_and_grad(mfn, params),
                          "full": lambda: value_and_grad(ffn, params)},
                  warmup=1)
    m, f = times["micro"], times["full"]
    log(f"  value+grad: microbatched {np.median(m):.3f} ms [{min(m):.3f}, "
        f"{max(m):.3f}], full batch {np.median(f):.3f} ms [{min(f):.3f}, "
        f"{max(f):.3f}] (CUDA events, median and range of 15, in three "
        f"turns)")
    profile_line(torch, "microbatched value+grad",
                 lambda: value_and_grad(mfn, params))
    launches, _ = lbfgs_run(torch, "microbatched L-BFGS", mfn, params,
                            case.phases[0].ftol,
                            {"fused_mlp_jet": 2 * MICROBATCHES,
                             "fused_mlp_jet_bwd": MICROBATCHES})
    del case, params
    torch.cuda.empty_cache()
    return add_launches(total, launches)


def endgame_checks(torch, dev, trees):
    """Phase 14: the extended-precision endgame on the plate's net-BC and
    analytic + Fourier64 configurations at scale 1.0.  Returns the kernel
    launches of the counted runs."""
    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.cases.base import (
        _phase_loss_fn,
        mixed_precision_phase_fn,
    )
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train.lbfgs_host import (
        make_host_phase_vg,
        make_preconditioned_vg,
        minimize_host,
    )
    from pinn_elastodynamics_torch.train.step import value_and_grad
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    total = None
    for name, (kw, trainable, key, fwd, bwd) in ENDGAME_CONFIGS.items():
        t0 = time.perf_counter()
        case = plate_hole.build(scale=1.0, device=dev, **kw)
        phase = dataclasses.replace(case.phases[-1], trainable=trainable)
        params = trees[key]
        host_vg, x0, unravel = make_host_phase_vg(case, phase, params)
        log(f"  {name}: {x0.size} trainable parameters ({trainable})")

        # The eager float64 reference on the card.
        fn64, sub64, _ = _phase_loss_fn(eager_f64_case(case), phase,
                                        to64(params))
        loss64, grads64 = value_and_grad(fn64, sub64)
        g64 = torch.cat([t.reshape(-1) for t in tree_leaves(grads64)])
        del grads64

        host_vg(x0)   # warm-up
        torch.cuda.synchronize()
        fj.reset_launches()
        fv.reset_launches()
        f_host, g_host = host_vg(x0)
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        want = dict.fromkeys(launches, 0)
        want[fwd] = want[bwd] = 1
        if launches != want:
            raise AssertionError(f"{name}: host_vg launches {launches}")
        total = add_launches(total, launches)
        rel = scaled_loss_error(f"{name} host_vg", f_host, loss64)
        g_scaled, g_abs = max_scaled(torch.as_tensor(g_host, device=dev), g64)
        log(f"  {name} host_vg: loss {f_host:.12g} (eager f64 "
            f"{float(loss64):.12g}, rel {rel:.2e}), gradient {g_scaled:.3e} "
            f"(max abs {g_abs:.3e}), launches {launches}")
        if not g_scaled <= TOL_GRAD:
            raise AssertionError(f"{name}: host_vg gradient {g_scaled:.3e}")

        # One device-to-host copy per evaluation (profiler).
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            host_vg(x0)
            torch.cuda.synchronize()
        d2h = sum(evt.count for evt in prof.key_averages()
                  if "DtoH" in evt.key or "Device -> Pageable" in evt.key)
        if d2h != 1:
            raise AssertionError(f"{name}: {d2h} device-to-host copies per "
                                 f"host_vg")
        z32 = torch.as_tensor(x0.astype(np.float32), device=dev)
        packed = host_vg.device(z32)
        arr = packed.cpu().numpy()
        split = {
            "host_vg": host_ms(torch, lambda: host_vg(x0)),
            "device value+grad": host_ms(torch,
                                         lambda: host_vg.device(z32)),
            "copy": host_ms(torch, lambda: packed.cpu()),
            "host sums": host_ms(torch, lambda: host_vg.host(arr)),
        }
        log(f"  {name} host_vg: {d2h} device-to-host copy of {arr.size} "
            f"floats; " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                    split.items())
            + " (host clock, median of 5)")

        # minimize_host: straight, resumed, whitened.
        evals, eval_ms = [0], []

        def timed_vg(z):
            start = time.perf_counter()
            out = host_vg(z)
            eval_ms.append(1e3 * (time.perf_counter() - start))
            evals[0] += 1
            return out

        fj.reset_launches()
        fv.reset_launches()
        start = time.perf_counter()
        straight = minimize_host(timed_vg, x0, maxiter=ENDGAME_ITERS,
                                 memory_size=50)
        wall_ms = 1e3 * (time.perf_counter() - start)
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        want = dict.fromkeys(launches, 0)
        want[fwd] = want[bwd] = straight.n_evals
        hist = straight.loss_history
        n = straight.n_iters
        log(f"  {name} minimize_host: {n} iterations, {straight.n_evals} "
            f"evaluations ({straight.converged}), loss {hist[0]:.9g} -> "
            f"{hist[-1]:.9g}; {1e3 * n / wall_ms:.3f} it/s, "
            f"{(straight.n_evals - 1) / n:.2f} line-search evaluations per "
            f"iteration, host_vg {np.median(eval_ms):.3f} ms [{min(eval_ms):.3f}"
            f", {max(eval_ms):.3f}], host optimizer "
            f"{(wall_ms - sum(eval_ms)) / n:.3f} ms per iteration; launches "
            f"{launches}")
        if (n != ENDGAME_ITERS or launches != want
                or not hist[-1] < hist[0]):
            raise AssertionError(f"{name}: minimize_host {n} iterations, "
                                 f"launches {launches}, history {hist}")
        total = add_launches(total, launches)

        fj.reset_launches()
        fv.reset_launches()
        half = ENDGAME_ITERS // 2
        first = minimize_host(host_vg, x0, maxiter=half, memory_size=50)
        second = minimize_host(host_vg, first.x, maxiter=ENDGAME_ITERS - half,
                               memory_size=50, init_carry=first.carry)
        same = (np.array_equal(second.x, straight.x)
                and second.final_loss == straight.final_loss)
        log(f"  {name} resumed {half} + {ENDGAME_ITERS - half}: loss "
            f"{second.final_loss:.12g}, straight {straight.final_loss:.12g}, "
            f"bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{name}: the resumed host run differs")
        total = add_launches(total, {**fj.LAUNCHES, **fv.LAUNCHES})

        # Per-leaf Jacobi whitening, as scripts/hybrid_endgame.py builds it.
        fj.reset_launches()
        fv.reset_launches()
        _, g0 = host_vg(x0)
        sizes = [t.numel() for t in tree_leaves(unravel(x0))]
        rmses, off = [], 0
        for sz in sizes:
            blk = g0[off:off + sz]
            rmses.append(max(float(np.sqrt((blk * blk).mean())), 1e-30))
            off += sz
        ref_rms = float(np.median(rmses))
        d = np.concatenate([np.full(sz, ref_rms / r, np.float64)
                            for sz, r in zip(sizes, rmses)])
        vg_u, to_u, _ = make_preconditioned_vg(host_vg, d)
        pre = minimize_host(vg_u, to_u(x0), maxiter=5, memory_size=50)
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        if not launches[fwd] == launches[bwd] == pre.n_evals + 1:
            raise AssertionError(f"{name}: whitened launches {launches}")
        total = add_launches(total, launches)
        log(f"  {name} whitened: d in [{d.min():.3g}, {d.max():.3g}], "
            f"{pre.n_iters} iterations, {pre.n_evals} evaluations, loss "
            f"{pre.loss_history[0]:.9g} -> {pre.final_loss:.9g}")
        if not pre.final_loss < pre.loss_history[0]:
            raise AssertionError(f"{name}: whitened loss did not fall")

        # Float64 parameters over the f32 compute path on the device.
        sub_fn, sub0, _ = mixed_precision_phase_fn(case, phase,
                                                   to64(params))
        loss, grads, launches, _ = counted_value_and_grad(
            torch, f"{name} mixed precision", sub_fn, sub0, {fwd: 1, bwd: 1})
        total = add_launches(total, launches)
        dtypes = {str(t.dtype) for t in tree_leaves(grads)} | {str(loss.dtype)}
        if dtypes != {"torch.float64"}:
            raise AssertionError(f"{name}: mixed precision dtypes {dtypes}")
        rel = scaled_loss_error(f"{name} mixed precision", loss, loss64)
        g_scaled, g_abs = max_scaled(
            torch.cat([t.reshape(-1) for t in tree_leaves(grads)]), g64)
        log(f"  {name} mixed precision: loss {float(loss):.12g} (rel "
            f"{rel:.2e}), gradient {g_scaled:.3e} (max abs {g_abs:.3e}), "
            f"float64 loss and gradients")
        if not g_scaled <= TOL_GRAD:
            raise AssertionError(f"{name}: mixed gradient {g_scaled:.3e}")
        launches, res = lbfgs_run(torch, f"{name} mixed precision", sub_fn,
                                  sub0, phase.ftol, {fwd: 1, bwd: 1})
        total = add_launches(total, launches)
        if {t.dtype for t in tree_leaves(res.params)} != {torch.float64}:
            raise AssertionError(f"{name}: the f64 tree left float64")
        del case, g64
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.2f} s")
    return total


def elastic3d_checks(torch, dev):
    """Phase 15: the 3D case and its MMS case at scale 1.0, then the CLI.
    Returns the kernel launches of the counted runs."""
    import os
    import tempfile

    from pinn_elastodynamics_torch.cases import elastic3d
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

    rng = np.random.default_rng(SEED + 10)
    total = None
    for name, (build_name, key) in ELASTIC3D_CONFIGS.items():
        t0 = time.perf_counter()
        case = getattr(elastic3d, build_name)(scale=1.0, device=dev)
        n_col = case.banks["collocation"].n_total
        dims, n_want = WAVE_SHAPES[key][:2]
        if n_col != n_want or list(case.model.layers) != dims:
            raise AssertionError(f"{name}: {n_col} points, widths "
                                 f"{case.model.layers}")
        params = params_from_jax(mlp_tree(rng, dims), device=dev)
        mms = build_name == "build_mms"
        before = elastic3d.mms_errors(case.model, params) if mms else None
        launches, res = drive_config(
            torch, name, case, params,
            {"fused_mlp_jet": 1, "fused_mlp_jet_bwd": 1})
        total = add_launches(total, launches)
        if mms:
            after = elastic3d.mms_errors(case.model, res.params)
            log(f"  {name} mms_errors before: " + ", ".join(
                f"{k} {v:.4g}" for k, v in before.items()))
            log(f"  {name} mms_errors after {res.n_iters} iterations: "
                + ", ".join(f"{k} {v:.4g}" for k, v in after.items()))
            if not all(np.isfinite(v) for v in after.values()):
                raise AssertionError(f"{name}: mms_errors {after}")
        del case, params, res
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli3d")
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pinn_elastodynamics_torch.run",
             *CLI_3D_ARGS, "--out", out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"3D CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = {e["event"]: e for e in map(json.loads, f)}
        log(f"  CLI {' '.join(CLI_3D_ARGS)}: exit 0 in "
            f"{time.perf_counter() - start:.2f} s, start {events['start']}, "
            f"phase_end {events['phase_end']}, components "
            f"{events['train_done']['components']}")
        comps = events["train_done"]["components"]
        if not ("cuda" in events["start"]["devices"][0]
                and np.all(np.isfinite(list(comps.values())))):
            raise AssertionError(f"3D CLI run: {events}")
    return total


def write_frame(fem_dir, i, xy, fields):
    """One ``ProbeData-<i>.mat``: x, y (FEM coordinates) and the fields, as
    column vectors."""
    import os

    import scipy.io

    data = {"x": xy[:, :1], "y": xy[:, 1:]}
    data.update({k: np.asarray(v)[:, None] for k, v in fields.items()})
    scipy.io.savemat(os.path.join(fem_dir, f"ProbeData-{i}.mat"), data)


def plate_probe_grid(rng):
    """N_PROBES quarter-plate probe points outside the hole, N_RING of them
    on the r = 0.1 hole arc."""
    xy = plate_points(rng, N_PROBES - N_RING).astype(np.float64)
    th = np.linspace(0.0, np.pi / 2, N_RING)
    return np.concatenate([xy, 0.1 * np.stack([np.cos(th), np.sin(th)], 1)])


def results_close(got, want, limit):
    """The largest relative difference between two nested comparison
    results (dicts and lists of floats); raises above ``limit``, naming
    where."""
    worst = (0.0, "")

    def walk(g, w, path):
        nonlocal worst
        if isinstance(w, dict):
            if sorted(g) != sorted(w):
                raise AssertionError(f"keys {sorted(g)} != {sorted(w)}")
            for k in w:
                walk(g[k], w[k], f"{path}[{k!r}]")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(g, w, strict=True)):
                walk(a, b, f"{path}[{i}]")
        else:
            worst = max(worst, (abs(g - w) / max(abs(w), 1e-300), path))

    walk(got, want, "")
    if not worst[0] <= limit:
        raise AssertionError(f"comparison results differ by {worst[0]:.3e} "
                             f"at {worst[1]}")
    return worst[0]


def all_errors(result):
    """Every relative L2 in a comparison result."""
    out = []
    for d in result.get("per_frame", []) + result.get("per_time", []):
        out += [v for k, v in d.items() if k != "t"]
    for key in ("aggregate", "aggregate_mid"):
        out += list(result.get(key, {}).values())
    return out


def fem_checks(torch, dev, net_p):
    """Phase 16: the FEM comparison at full width on synthetic frames.
    Returns the kernel launches of the counted comparisons."""
    import os
    import tempfile

    from pinn_elastodynamics_torch.cases import plate_hole, wave_confined
    from pinn_elastodynamics_torch.eval import compare, metrics
    from pinn_elastodynamics_torch.eval.render import predict_fields
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

    rng = np.random.default_rng(SEED + 11)
    wave = wave_confined.build(scale=0.02, device=dev)
    # name -> (case, parameters, kernel, FEM probe coordinates)
    configs = {
        "plate_net_bc": (plate_hole.build(scale=0.02, device=dev), net_p,
                         "fused_composite_jet", plate_probe_grid(rng)),
        "wave_confined_soft": (
            wave, params_from_jax(wave_params(rng, wave.model), device=dev),
            "fused_mlp_jet", rng.uniform(0.0, 30.0, (N_PROBES, 2))),
    }
    total = None

    def counted(fn, want):
        fj.reset_launches()
        fv.reset_launches()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        expected = dict.fromkeys(launches, 0)
        expected.update(want)
        if launches != expected:
            raise AssertionError(f"launches {launches} != {expected}")
        return out, wall, launches

    with tempfile.TemporaryDirectory() as tmp:
        exact, perturbed = (os.path.join(tmp, k) for k in ("exact", "bumped"))
        for name, (case, params, kernel, xy) in configs.items():
            t0 = time.perf_counter()
            eager = dataclasses.replace(case, model=eager_copy(case.model))
            p64 = to64(params)
            wave_keys = name.startswith("wave")   # amp and Mises in frames
            pinn_xy = xy + np.asarray(case.fem_offset)
            dirs = [compare.fem_path(case, root) for root in (exact, perturbed)]
            for d in dirs:
                os.makedirs(d)
            n = case.n_frames
            for i in range(n):
                pred = predict_fields(eager.model, p64, pinn_xy,
                                      case.frame_time(i), dtype=np.float64,
                                      device=dev)
                fields = {k: pred[k] for k in ("u", "v", "s11", "s22", "s12")}
                if wave_keys:
                    fields["amp"] = pred["amp"]
                    fields["Mises"] = metrics.von_mises_2d(
                        pred["s11"], pred["s22"], pred["s12"],
                        mu=case.material.mu, plane=case.plane)
                write_frame(dirs[0], i, xy, fields)
                span = np.ptp(xy, axis=0)
                bump = np.sin(2.0 * xy[:, 0] / span[0] + 3.0 * xy[:, 1]
                              / span[1] + 0.3 * i)
                write_frame(dirs[1], i, xy, {
                    k: v + PERTURB * np.sqrt(np.mean(v * v)) * bump
                    for k, v in fields.items()})
            log(f"  {name}: {n} frames of {N_PROBES} probes written twice "
                f"(eager f64 predictions, and the same with a smooth bump of "
                f"{PERTURB} x RMS) in {time.perf_counter() - t0:.2f} s")

            got, wall, launches = counted(
                lambda: compare.compare_frames(case, params, dtype=np.float32,
                                               fem_root=exact), {kernel: n})
            total = add_launches(total, launches)
            worst = max(all_errors(got))
            log(f"  {name} compare_frames, exact frames: {n} frames, "
                f"{1e3 * wall / n:.3f} ms per frame (host clock, loadmat "
                f"included), largest relative L2 {worst:.3e} over "
                f"{len(all_errors(got))} numbers, launches {launches}")
            if not worst <= TOL_FEM:
                raise AssertionError(f"{name}: kernel path error {worst:.3e}")
            got, wall, launches = counted(
                lambda: compare.compare_frames(case, params, dtype=np.float32,
                                               fem_root=perturbed),
                {kernel: n})
            total = add_launches(total, launches)
            ref = compare.compare_frames(eager, p64, dtype=np.float64,
                                         fem_root=perturbed)
            rel = results_close(got, ref, TOL_FEM_MATCH)
            log(f"  {name} compare_frames, bumped frames: aggregate "
                + ", ".join(f"{k} {v:.5f}" for k, v in got["aggregate"].items())
                + f"; kernel path against eager f64 {rel:.3e} relative, "
                f"{1e3 * wall / n:.3f} ms per frame")
            xyt_ms = host_ms(torch, lambda: predict_fields(
                case.model, params, pinn_xy, 2.5, device=dev))
            log(f"  {name} predict_fields alone: {xyt_ms:.3f} ms per frame "
                f"of {N_PROBES} points (host clock, median of 5)")
            if name == "plate_net_bc":
                edge, _, launches = counted(
                    lambda: compare.hole_edge_errors(
                        case, params, dtype=np.float32, fem_root=exact),
                    {kernel: 3})
                total = add_launches(total, launches)
                edge_exact = max(all_errors(edge))
                if not edge_exact <= TOL_FEM:
                    raise AssertionError(f"hole edge, exact frames: {edge}")
                edge, _, launches = counted(
                    lambda: compare.hole_edge_errors(
                        case, params, dtype=np.float32, fem_root=perturbed),
                    {kernel: 3})
                total = add_launches(total, launches)
                ref = compare.hole_edge_errors(eager, p64, dtype=np.float64,
                                               fem_root=perturbed)
                rel = results_close(edge, ref, TOL_FEM_MATCH)
                log(f"  hole_edge_errors ({N_RING} arc probes, t = 2.5, "
                    f"3.75, 5.0): exact frames largest {edge_exact:.3e}; "
                    f"bumped aggregate "
                    + ", ".join(f"{k} {v:.5f}"
                                for k, v in edge["aggregate"].items())
                    + f", against eager f64 {rel:.3e} relative")
            log(f"  {name}: {time.perf_counter() - t0:.2f} s")

        out = os.path.join(tmp, "cli")
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pinn_elastodynamics_torch.run",
             *FEM_CLI_ARGS, "--fem-root", exact, "--out", out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"--compare-fem CLI exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(os.path.join(out, "fem_errors.json")) as f:
            written = json.load(f)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = {e["event"]: e for e in map(json.loads, f)}
        agg = written["aggregate"]
        log(f"  CLI {' '.join(FEM_CLI_ARGS)}: exit 0 in "
            f"{time.perf_counter() - start:.2f} s, {len(written['frames'])} "
            f"frames, aggregate " + ", ".join(f"{k} {v:.4g}"
                                              for k, v in agg.items()))
        if not ("cuda" in events["start"]["devices"][0]
                and {"fem_errors", "fem_errors_mid"} <= set(events)
                and len(written["frames"]) == 17
                and sorted(agg) == ["s11", "s12", "s22", "u", "v"]
                and np.all(np.isfinite(list(agg.values())))):
            raise AssertionError(f"--compare-fem CLI: {events}, {agg}")
    return total


def plane_p_wave(x, t):
    """u = A·sin(k(x - c_p·t)), v = 0: with lambda = G = 1 (E = 2.5, nu =
    0.25) and rho = 1, c_p² = 3, s11 = 3Ak·cos, s22 = Ak·cos, s12 = 0."""
    ph = PWAVE_K * (x - np.sqrt(3.0) * t)
    c = PWAVE_AMP * PWAVE_K * np.cos(ph)
    zero = np.zeros_like(x)
    return {"u": PWAVE_AMP * np.sin(ph), "v": zero, "s11": 3.0 * c,
            "s22": c, "s12": zero}


def inverse_checks(torch, dev):
    """Phase 17: the inverse problem at full width.  Returns the kernel
    launches of the counted runs and the timings of B1 and B2 at the
    acceleration sensors' shape (order 2) and the collocation's (order
    1)."""
    import os
    import tempfile

    from pinn_elastodynamics_torch.banks import PointBank
    from pinn_elastodynamics_torch.cases import inverse, wave_confined
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.models.mlp import seed_jet
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
    from pinn_elastodynamics_torch.train.lbfgs_host import (
        make_host_problem_vg,
        minimize_host,
    )
    from pinn_elastodynamics_torch.train.step import value_and_grad

    rng = np.random.default_rng(SEED + 12)
    with tempfile.TemporaryDirectory() as tmp:
        fem_dir = os.path.join(tmp, wave_confined.FEM_DIR)
        os.makedirs(fem_dir)
        xy = rng.uniform(0.0, 30.0, (N_PROBES, 2))
        start = time.perf_counter()
        for i in range(57):
            write_frame(fem_dir, i, xy, plane_p_wave(xy[:, 0] - 15.0,
                                                     i * 14.0 / 56))
        problem, banks = inverse.build(scale=1.0, fem_dir=fem_dir,
                                       accel_weight=INVERSE_ACCEL, device=dev)
    sizes = {k: b.n_total for k, b in banks.items()}
    log(f"  frames 0-56 of the plane wave at {N_PROBES} probes, build "
        f"{time.perf_counter() - start:.2f} s: banks {sizes}, weights "
        f"{dict(problem.weights)}")
    lo, hi = INVERSE_COLLOCATION
    if (sizes["sensors"] != N_INVERSE_SENSORS
            or not lo < sizes["collocation"] < hi):
        raise AssertionError(f"inverse banks {sizes}")
    dims = list(problem.model.layers)
    params = params_from_jax(
        {"net": mlp_tree(rng, dims), "log_E": np.log(problem.E_init),
         "log_rho": np.log(problem.rho_init)}, device=dev)
    fn = problem.loss_fn(banks)
    per_eval = {"fused_mlp_jet": 2, "fused_mlp_jet_bwd": 2}
    loss, grads, launches, peak = counted_value_and_grad(
        torch, "inverse value+grad (collocation order 1, sensors order 2)",
        fn, params, per_eval)
    total = dict(launches)

    # Eager float64 on the card.
    eager = dataclasses.replace(problem, model=eager_copy(problem.model))
    banks64 = {k: PointBank(b.xyt.double(), b.mask.double(),
                            {v: t.double() for v, t in b.values.items()})
               for k, b in banks.items()}
    loss64, grads64 = value_and_grad(eager.loss_fn(banks64), to64(params))
    rel = scaled_loss_error("inverse value+grad", loss, loss64)
    g_scaled, g_abs = check_grads("inverse value+grad", grads, grads64)
    log(f"  inverse: loss {float(loss):.9g} (eager f64 {float(loss64):.9g}, "
        f"rel {rel:.2e}), gradients {g_scaled:.3e} (max abs {g_abs:.3e}); "
        f"d/dlog_E {float(grads['log_E']):.6g} (f64 "
        f"{float(grads64['log_E']):.6g}), d/dlog_rho "
        f"{float(grads['log_rho']):.6g} (f64 {float(grads64['log_rho']):.6g})"
        f"; peak device memory {peak / 2**30:.2f} GiB")
    del grads64, banks64
    fj.reset_launches()
    fv.reset_launches()
    again = value_and_grad(fn, params)[1]
    same = bitwise_equal(grads, again)
    log(f"  inverse value+grad twice: gradients bitwise equal: {same}")
    if not same:
        raise AssertionError("inverse: two value+grads differ")
    total = add_launches(total, {**fj.LAUNCHES, **fv.LAUNCHES})

    # B1 and B2 at the acceleration sensors' shape (order 2, 140 wide),
    # against their plain float64 versions and timed.
    net, net64 = params["net"], to64(params["net"])
    x = banks["sensors"].xyt
    n = x.shape[0]
    with torch.no_grad():
        ker = fv.fused_jet_vjp(net, x, order=2)
        b1_err = check_jet(f"B1 inverse widths 140 n={n} order=2", ker,
                           fj.fused_jet_reference(net64, x.double(), order=2))
    h0, d, dtt = (t.contiguous() for t in seed_jet(x, order=2))
    cot = torch.as_tensor(rng.standard_normal((5, n, dims[-1])),
                          dtype=torch.float32, device=dev)
    first = fv.fused_mlp_jet_bwd(net, h0, d, dtt, cot, full_dx=False)
    second = fv.fused_mlp_jet_bwd(net, h0, d, dtt, cot, full_dx=False)
    ref_g, ref_dx = fv.mlp_jet_bwd_reference(net64, h0.double(), d.double(),
                                             dtt.double(), cot.double())
    b2_scaled, b2_abs = check_grads("B2 inverse order 2", first[0], ref_g)
    dx_scaled, dx_abs = max_scaled(first[1], ref_dx[0])
    same = bitwise_equal(first, second)
    log(f"  B2 inverse widths 140 n={n} order=2: grads {b2_scaled:.3e}, dx "
        f"{dx_scaled:.3e} (max abs {max(b2_abs, dx_abs):.3e}), two runs "
        f"bitwise equal: {same}")
    if not (same and dx_scaled <= TOL_GRAD):
        raise AssertionError("B2 at the inverse's order-2 shape")
    n_par = n_params(net)
    with torch.no_grad():
        fwd = time_kernel(
            torch, "fused_mlp_jet",
            lambda: fj.fused_jet_stack(net, x, order=2),
            lambda: fj.fused_jet_reference(net, x, order=2),
            flops_per_point(dims, 5) * n,
            4 * (x.numel() + 5 * n * dims[-1] + n_par), f"inverse n={n} order=2")
    bwd = time_kernel(
        torch, "fused_mlp_jet_bwd",
        lambda: fv.fused_mlp_jet_bwd(net, h0, d, dtt, cot, full_dx=False),
        lambda: fv.mlp_jet_bwd_reference(net, h0, d, dtt, cot),
        bwd_flops_per_point(dims, 5) * n,
        4 * (h0.numel() + d.numel() + dtt.numel() + cot.numel()
             + 2 * n_par + h0.numel()), f"inverse n={n} order=2", runs=10)
    # And at the collocation's order-1 shape, which the profile below
    # should show as well.
    xc = banks["collocation"].xyt
    nc = xc.shape[0]
    ch0, cd, _ = (t if t is None else t.contiguous()
                  for t in seed_jet(xc, order=1))
    ccot = torch.as_tensor(rng.standard_normal((4, nc, dims[-1])),
                           dtype=torch.float32, device=dev)
    with torch.no_grad():
        fwd1 = time_kernel(
            torch, "fused_mlp_jet",
            lambda: fj.fused_jet_stack(net, xc, order=1),
            lambda: fj.fused_jet_reference(net, xc, order=1),
            flops_per_point(dims, 4) * nc,
            4 * (xc.numel() + 4 * nc * dims[-1] + n_par),
            f"inverse n={nc} order=1")
    bwd1 = time_kernel(
        torch, "fused_mlp_jet_bwd",
        lambda: fv.fused_mlp_jet_bwd(net, ch0, cd, None, ccot, full_dx=False),
        lambda: fv.mlp_jet_bwd_reference(net, ch0, cd, None, ccot),
        bwd_flops_per_point(dims, 4) * nc,
        4 * (ch0.numel() + cd.numel() + ccot.numel() + 2 * n_par
             + ch0.numel()), f"inverse n={nc} order=1", runs=10)
    del ch0, cd, ccot
    timings = {
        "fused_mlp_jet": {"inverse_order2": dict(fwd, max_abs_err=b1_err),
                          "inverse_order1": fwd1},
        "fused_mlp_jet_bwd": {
            "inverse_order2": dict(bwd, max_abs_err=max(b2_abs, dx_abs)),
            "inverse_order1": bwd1},
    }

    efn = eager.loss_fn(banks)
    times = turns(torch, {"kernel": lambda: value_and_grad(fn, params),
                          "eager": lambda: value_and_grad(efn, params)})
    ker, eag = times["kernel"], times["eager"]
    log(f"  value+grad inverse: kernel path {np.median(ker):.3f} ms "
        f"[{min(ker):.3f}, {max(ker):.3f}], eager f32 {np.median(eag):.3f} "
        f"ms [{min(eag):.3f}, {max(eag):.3f}] (CUDA events, median and "
        f"range of 15, in three turns)")
    profile_line(torch, "value+grad inverse",
                 lambda: value_and_grad(fn, params))

    launches, res = lbfgs_run(torch, "inverse device L-BFGS", fn, params,
                              0.0, per_eval)
    total = add_launches(total, launches)
    log(f"  inverse device L-BFGS: E {float(torch.exp(res.params['log_E'])):.6g}"
        f", rho {float(torch.exp(res.params['log_rho'])):.6g} (from "
        f"{problem.E_init:g}, {problem.rho_init:g}; answer 2.5, 1)")

    host_vg, x0, unravel = make_host_problem_vg(problem, banks, params)
    f0, _ = host_vg(x0)
    host_rel = scaled_loss_error("inverse host_vg", f0, loss64)
    fj.reset_launches()
    fv.reset_launches()
    start = time.perf_counter()
    hres = minimize_host(host_vg, x0, maxiter=INVERSE_ITERS, memory_size=50)
    wall = time.perf_counter() - start
    launches = {**fj.LAUNCHES, **fv.LAUNCHES}
    want = dict.fromkeys(launches, 0)
    want.update({k: v * hres.n_evals for k, v in per_eval.items()})
    end = unravel(hres.x)
    hist = hres.loss_history
    log(f"  inverse minimize_host: x0 of {x0.size} (log_E, log_rho, net), "
        f"host_vg loss {f0:.12g} (rel {host_rel:.2e} to eager f64); "
        f"{hres.n_iters} iterations, {hres.n_evals} evaluations "
        f"({hres.converged}), loss {hist[0]:.9g} -> {hist[-1]:.9g}; "
        f"{hres.n_iters / wall:.3f} it/s, "
        f"{(hres.n_evals - 1) / hres.n_iters:.2f} line-search evaluations "
        f"per iteration; E {float(torch.exp(end['log_E'])):.6g}, rho "
        f"{float(torch.exp(end['log_rho'])):.6g}; launches {launches}")
    if (hres.n_iters != INVERSE_ITERS or launches != want
            or not hist[-1] < hist[0]):
        raise AssertionError(f"inverse minimize_host: {hres.n_iters} "
                             f"iterations, launches {launches}")
    total = add_launches(total, launches)
    del problem, banks, params, res, hres
    torch.cuda.empty_cache()
    return total, timings


def adaptive_checks(torch, dev):
    """Phase 18: residual-driven resampling on wave_confined at scale 1.0
    and full width.  Returns the kernel launches of the counted run."""
    from pinn_elastodynamics_torch.cases import wave_confined
    from pinn_elastodynamics_torch.geometry.adaptive import (
        pointwise_residual_norm,
        residual_resample,
        topk_refine,
    )
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

    rng = np.random.default_rng(SEED + 13)
    case = wave_confined.build(scale=1.0, device=dev)
    bank = case.banks["collocation"]
    if bank.n_total != N_ADAPTIVE:
        raise AssertionError(f"{bank.n_total} collocation points")
    params = params_from_jax(wave_params(rng, case.model), device=dev)
    lo, hi = (np.asarray(b) for b in CONFINED_BOX)
    cands = (lo + (hi - lo) * rng.uniform(size=(N_ADAPTIVE, 3)))
    pool = (lo + (hi - lo) * rng.uniform(size=(N_POOL, 3)))
    args = (case.model, params, case.material, case.plane)

    # The residual norms against eager float64 (launches not counted).
    x = torch.as_tensor(cands.astype(np.float32), device=dev)
    r = pointwise_residual_norm(*args, x)
    r64 = pointwise_residual_norm(eager_copy(case.model), to64(params),
                                  case.material, case.plane, x.double())
    scaled, err = max_scaled(r, r64)
    log(f"  residual norms at {N_ADAPTIVE} candidates: {scaled:.3e} scaled "
        f"(max abs {err:.3e}, max {float(r64.max()):.4g}) against eager f64")
    if not scaled <= TOL_FD:
        raise AssertionError(f"residual norms differ by {scaled:.3e}")

    fj.reset_launches()
    fv.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    new, info = topk_refine(*args, bank, cands, ADAPTIVE_K)
    torch.cuda.synchronize()
    refine_ms = 1e3 * (time.perf_counter() - start)
    start = time.perf_counter()
    drawn = residual_resample(*args, pool, N_ADAPTIVE, seed=SEED,
                              batch=POOL_BATCH)
    resample_ms = 1e3 * (time.perf_counter() - start)
    launches = {**fj.LAUNCHES, **fv.LAUNCHES}
    want = dict.fromkeys(launches, 0)
    want["fused_mlp_jet"] = N_POOL // POOL_BATCH + 2
    log(f"  topk_refine k={ADAPTIVE_K} from {N_ADAPTIVE} candidates into "
        f"{N_ADAPTIVE} points: {refine_ms:.3f} ms, {info}; "
        f"residual_resample of {N_ADAPTIVE} from {N_POOL} in batches of "
        f"{POOL_BATCH}: {resample_ms:.3f} ms (host clock); launches "
        f"{launches}")
    changed = int((new.xyt != bank.xyt).any(dim=1).sum())
    if (launches != want or changed != ADAPTIVE_K
            or drawn.shape != (N_ADAPTIVE, 3)
            or not info["cand_residual_mean"] > float(r.mean())):
        raise AssertionError(f"adaptive: launches {launches}, {changed} rows "
                             f"changed, drawn {drawn.shape}, {info}")
    del case, bank, new, params
    torch.cuda.empty_cache()
    return launches


def native_checks():
    """Phase 19: the port's native point generation, built on this host,
    against its numpy geometry at N_NATIVE points."""
    from pinn_elastodynamics_torch.geometry import distance, native
    from pinn_elastodynamics_torch.geometry import sampling as smp

    start = time.perf_counter()
    if not native.available():
        raise AssertionError(f"libpointgen: {native.load_error()}")
    log(f"  libpointgen built and loaded in {time.perf_counter() - start:.2f} "
        f"s ({native.library_path().name}, {native.num_threads()} OpenMP "
        f"threads)")
    rng = np.random.default_rng(SEED + 14)

    def timed(label, fast, plain, same):
        t0 = time.perf_counter()
        a = fast()
        t1 = time.perf_counter()
        b = plain()
        t2 = time.perf_counter()
        if not same(a, b):
            raise AssertionError(f"native {label} differs from numpy")
        log(f"  {label}: native {t1 - t0:.4f} s, numpy {t2 - t1:.4f} s, "
            f"equal")

    pts = rng.uniform(-1.0, 1.0, (N_NATIVE, 3))
    for strict in (True, False):
        timed(f"exclude_disk strict={strict} n={N_NATIVE}",
              lambda: native.exclude_disk(pts, xc=0.1, yc=-0.2, r=0.5,
                                          strict=strict),
              lambda: smp.exclude_disk(pts, xc=0.1, yc=-0.2, r=0.5,
                                       strict=strict), np.array_equal)
    xyt = rng.uniform(0.0, 0.5, (N_NATIVE, 3)) * np.array([1.0, 1.0, 20.0])
    timed(f"plate_hole_distance n={N_NATIVE}",
          lambda: native.plate_hole_distance(xyt),
          lambda: distance.plate_hole_distance(xyt),
          lambda a, b: np.allclose(a, b, rtol=0, atol=1e-15))
    xy, t = rng.uniform(size=(N_NATIVE // 128, 2)), np.linspace(0, 10, 128)
    timed(f"cross_time n={N_NATIVE}", lambda: native.cross_time(xy, t),
          lambda: smp.cross_time(xy, t), np.array_equal)

    t0 = time.perf_counter()
    s = native.lhs(3, N_NATIVE, seed=42)
    t1 = time.perf_counter()
    smp.lhs(3, N_NATIVE, rng)
    t2 = time.perf_counter()
    strata = np.floor(s * N_NATIVE).astype(np.int64)
    stratified = all(np.array_equal(np.sort(strata[:, j]),
                                    np.arange(N_NATIVE)) for j in range(3))
    box = native.lhs_box((-2.0, 0.0, 1.0), (3.0, 0.5, 11.0), N_NATIVE,
                         seed=3)
    inside = bool((box.min(0) >= (-2.0, 0.0, 1.0)).all()
                  and (box.max(0) <= (3.0, 0.5, 11.0)).all())
    log(f"  lhs 3 x {N_NATIVE}: native {t1 - t0:.4f} s, numpy {t2 - t1:.4f} "
        f"s; one point per stratum in each dimension: {stratified}; "
        f"lhs_box inside its box: {inside}")
    if not (stratified and inside):
        raise AssertionError("native LHS")


def mesh_case(dev, name, pad, scale):
    """A phase-20 configuration's case, its banks padded to ``pad``."""
    import importlib

    mod_name, kw = MESH_CONFIGS[name][:2]
    mod = importlib.import_module(f"pinn_elastodynamics_torch.cases.{mod_name}")
    return mod.build(scale=scale, pad_to_multiple_of=pad, device=dev, **kw)


def mesh_pad(name, size):
    """Banks padded to the world size, times the microbatches."""
    return size * max(1, MESH_CONFIGS[name][3])


def mesh_loss(case, name, params):
    """(fn, sub) of a phase-20 configuration: the main phase's loss over its
    trainable subtree, or the microbatched loss over every parameter."""
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.train.step import make_microbatched_loss_fn

    trainable, micro = MESH_CONFIGS[name][2:4]
    if micro:
        loss = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                         num_microbatches=micro)
        return (lambda p: loss(p, case.banks)[0]), params
    phase = dataclasses.replace(case.phases[-1], trainable=trainable)
    fn, sub, _ = _phase_loss_fn(case, phase, params)
    return fn, sub


def mesh_trees(rng):
    """Full-width random parameters (JAX layout, numpy f32) of each
    phase-20 configuration."""
    from pinn_elastodynamics_torch.cases import plate_hole, wave_confined

    small = [3] + [20] * 4 + [5]
    return {
        "net_bc": {"uv": mlp_tree(rng, [3] + [70] * 8 + [5]),
                   "dist": mlp_tree(rng, small), "part": mlp_tree(rng, small)},
        "analytic_fourier64": wave_params(rng, plate_hole.build_model(
            **MESH_CONFIGS["analytic_fourier64"][1])),
        "W1_microbatched": wave_params(rng, wave_confined.build_model()),
    }


def counted_mesh_vg(torch, fn, sub, sync):
    """One value+grad after a warm-up, with the kernel launches and the
    reductions it made: (loss, grads, launches, collectives)."""
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.parallel import mesh as pmesh
    from pinn_elastodynamics_torch.train.step import value_and_grad

    value_and_grad(fn, sub)   # warm-up
    sync()
    fj.reset_launches()
    fv.reset_launches()
    pmesh.reset_collectives()
    loss, grads = value_and_grad(fn, sub)
    sync()
    return (loss, grads, {**fj.LAUNCHES, **fv.LAUNCHES},
            dict(pmesh.COLLECTIVES))


def flat_numpy(tree):
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    return np.concatenate([t.detach().reshape(-1).cpu().numpy()
                           for t in tree_leaves(tree)])


def mesh_rank(rank, root):
    """One rank of phase 20's gloo world (spawned): each configuration's
    value+grad on its shard, host-clock times, and net-BC's L-BFGS
    iterations; the results go to ``root/rank<rank>.pkl``."""
    import datetime
    import os
    import pickle

    import torch
    import torch.distributed as dist

    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.parallel import mesh as pmesh
    from pinn_elastodynamics_torch.train import lbfgs
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
    from pinn_elastodynamics_torch.train.step import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(root, "setup.pkl"), "rb") as f:
        setup = pickle.load(f)
    dev = torch.device(setup["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), MESH_WORLD),
        rank=rank, world_size=MESH_WORLD,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out = {}
    try:
        mesh = pmesh.make_mesh(device=dev)
        for name in MESH_CONFIGS:
            case = mesh_case(dev, name, mesh_pad(name, MESH_WORLD),
                             setup["scale"])
            case = dataclasses.replace(
                case, banks=pmesh.shard_banks(case.banks, mesh))
            params = pmesh.replicate(
                params_from_jax(setup["trees"][name], device=dev), mesh)
            fn, sub = mesh_loss(case, name, params)
            loss, grads, launches, coll = counted_mesh_vg(torch, fn, sub,
                                                          sync)
            times = []
            for _ in range(5):
                start = time.perf_counter()
                value_and_grad(fn, sub)
                sync()
                times.append(1e3 * (time.perf_counter() - start))
            res = dict(loss=float(loss), grads=flat_numpy(grads),
                       launches=launches, collectives=coll, ms=times,
                       rows=case.banks["collocation"].n_total)
            if name == "net_bc":
                evals = []

                def counted(p):
                    evals.append(1)
                    return fn(p)

                fj.reset_launches()
                fv.reset_launches()
                pmesh.reset_collectives()
                start = time.perf_counter()
                run = lbfgs.minimize(counted, sub, maxiter=MESH_LBFGS_ITERS,
                                     segment=MESH_LBFGS_ITERS)
                sync()
                res["lbfgs"] = dict(
                    wall_ms=1e3 * (time.perf_counter() - start),
                    loss=float(run.final_loss), iters=run.n_iters,
                    evals=len(evals), params=flat_numpy(run.params),
                    launches={**fj.LAUNCHES, **fv.LAUNCHES},
                    collectives=dict(pmesh.COLLECTIVES))
            out[name] = res
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mesh_checks(torch, dev):
    """Phase 20: data parallelism over the points axis.  (a) The net-BC
    plate sharded over a world of one in this process against the mesh-less
    value+grad, with its launches, reductions and times; (b) a gloo world
    of MESH_WORLD spawned ranks on one card against the mesh-less
    value+grads of the same weights.  Returns the kernel launches of the
    counted runs."""
    import datetime
    import multiprocessing
    import os
    import pickle
    import tempfile

    import torch.distributed as dist

    from pinn_elastodynamics_torch.parallel import mesh as pmesh
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
    from pinn_elastodynamics_torch.train.step import value_and_grad

    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    sync = torch.cuda.synchronize
    trees = mesh_trees(np.random.default_rng(SEED + 20))

    # (a) A world of one in this process.
    dist.init_process_group(MESH_BACKEND_1, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=datetime.timedelta(
                                seconds=MESH_TIMEOUT_S))
    try:
        mesh = pmesh.make_mesh(device=dev)
        case = mesh_case(dev, "net_bc", 1, MESH_SCALE)
        params = params_from_jax(trees["net_bc"], device=dev)
        fn, sub = mesh_loss(case, "net_bc", params)
        sharded = dataclasses.replace(
            case, banks=pmesh.shard_banks(case.banks, mesh))
        sfn, ssub = mesh_loss(sharded, "net_bc", pmesh.replicate(params, mesh))
        loss, grads, launches, coll = counted_mesh_vg(torch, sfn, ssub, sync)
        ref, ref_grads = value_and_grad(fn, sub)
        rel = abs(float(loss) - float(ref)) / abs(float(ref))
        g_scaled, g_abs = check_grads("world of one", grads, ref_grads)
        log(f"  {MESH_BACKEND_1} world of 1, net-BC uv phase at scale "
            f"{MESH_SCALE}: loss {float(loss):.9g} (mesh-less "
            f"{float(ref):.9g}, rel {rel:.2e}), gradients {g_scaled:.3e} "
            f"(max abs {g_abs:.3e}), bitwise "
            f"{bool(torch.equal(loss, ref)) and bitwise_equal(grads, ref_grads)}"
            f"; launches {launches}, collectives {coll}")
        expected = dict.fromkeys(launches, 0)
        expected.update(MESH_CONFIGS["net_bc"][4])
        if launches != expected or coll != {"sums": 1, "grads": 1}:
            raise AssertionError(f"world of one: launches {launches}, "
                                 f"collectives {coll}")
        if not rel <= TOL_MESH:
            raise AssertionError(f"world of one: loss differs by {rel:.2e}")
        total = dict(launches)
        times = turns(torch, {"mesh-less": lambda: value_and_grad(fn, sub),
                              "world 1": lambda: value_and_grad(sfn, ssub)})
        a, b = times["mesh-less"], times["world 1"]
        log(f"  value+grad net-BC: mesh-less {np.median(a):.3f} ms "
            f"[{min(a):.3f}, {max(a):.3f}], {MESH_BACKEND_1} world of 1 "
            f"{np.median(b):.3f} ms [{min(b):.3f}, {max(b):.3f}] (CUDA "
            f"events, median and range of 15, in three turns; "
            f"{card_line(torch)})")
        del case, sharded, grads, ref_grads
    finally:
        dist.destroy_process_group()

    # (b) A gloo world of MESH_WORLD spawned ranks, all on one card.
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "setup.pkl"), "wb") as f:
            pickle.dump(dict(device=MESH_DEVICE, scale=MESH_SCALE,
                             trees=trees), f)
        start = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank, args=(r, root))
                 for r in range(MESH_WORLD)]
        for p in procs:
            p.start()
        try:
            refs = {}
            for name in MESH_CONFIGS:   # the world of one, meanwhile
                case = mesh_case(dev, name, mesh_pad(name, MESH_WORLD),
                                 MESH_SCALE)
                fn, sub = mesh_loss(
                    case, name, params_from_jax(trees[name], device=dev))
                refs[name] = (value_and_grad(fn, sub),
                              case.banks["collocation"].n_total)
                del case
            for p in procs:
                p.join(max(1.0, MESH_JOIN_S - (time.perf_counter() - start)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        wall = time.perf_counter() - start
        codes = [p.exitcode for p in procs]
        if codes != [0] * MESH_WORLD:
            raise AssertionError(f"gloo world: rank exit codes {codes}")
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    log(f"  gloo world of {MESH_WORLD} on {MESH_DEVICE}: {wall:.2f} s from "
        f"spawn to exit")
    for name, (_, _, _, _, per_eval) in MESH_CONFIGS.items():
        (ref, ref_grads), n_rows = refs[name]
        first = ranks[0][name]
        for r, rank in enumerate(ranks):
            res = rank[name]
            expected = dict.fromkeys(res["launches"], 0)
            expected.update(per_eval)
            if (res["launches"] != expected
                    or res["collectives"] != {"sums": 1, "grads": 1}):
                raise AssertionError(f"{name} rank {r}: launches "
                                     f"{res['launches']}, collectives "
                                     f"{res['collectives']}")
            if res["rows"] * MESH_WORLD != n_rows:
                raise AssertionError(f"{name} rank {r}: {res['rows']} of "
                                     f"{n_rows} collocation rows")
            if (res["loss"] != first["loss"]
                    or not np.array_equal(res["grads"], first["grads"])):
                raise AssertionError(f"{name}: ranks 0 and {r} differ")
            total = add_launches(total, res["launches"])
        if name == "net_bc" and first["rows"] != N_MESH_HALF:
            raise AssertionError(f"net_bc: {first['rows']} rows per rank")
        rel = abs(first["loss"] - float(ref)) / abs(float(ref))
        ref_leaves = tree_leaves(ref_grads)
        got = torch.split(torch.as_tensor(first["grads"], device=dev),
                          [t.numel() for t in ref_leaves])
        g_scaled, g_abs = check_grads(
            f"{name} gloo world", [g.view(t.shape) for g, t in
                                   zip(got, ref_leaves)], ref_leaves)
        ms = [f"{np.median(r[name]['ms']):.3f}" for r in ranks]
        log(f"  {name}: {first['rows']} of {n_rows} collocation rows per "
            f"rank; loss {first['loss']:.9g} (world of one "
            f"{float(ref):.9g}, rel {rel:.2e}), gradients {g_scaled:.3e} "
            f"(max abs {g_abs:.3e}), ranks bitwise equal; launches per "
            f"value+grad {first['launches']}, collectives "
            f"{first['collectives']}; value+grad per rank {', '.join(ms)} ms "
            f"(host clock, median of 5, both ranks sharing one card)")
        if not rel <= TOL_LOSS:
            raise AssertionError(f"{name}: gloo loss differs by {rel:.2e}")
    runs = [r["net_bc"]["lbfgs"] for r in ranks]
    for r, run in enumerate(runs):
        want = dict.fromkeys(run["launches"], 0)
        want.update({k: n * run["evals"]
                     for k, n in MESH_CONFIGS["net_bc"][4].items()})
        if (run["iters"] != MESH_LBFGS_ITERS or run["launches"] != want
                or run["collectives"] != {"sums": run["evals"],
                                          "grads": run["evals"]}):
            raise AssertionError(f"net_bc L-BFGS rank {r}: {run}")
        if (run["evals"] != runs[0]["evals"] or run["loss"] != runs[0]["loss"]
                or not np.array_equal(run["params"], runs[0]["params"])):
            raise AssertionError(f"net_bc L-BFGS: ranks 0 and {r} differ")
        total = add_launches(total, run["launches"])
    first_loss = ranks[0]["net_bc"]["loss"]
    walls = ", ".join(f"{run['wall_ms']:.1f}" for run in runs)
    log(f"  net_bc L-BFGS, {MESH_LBFGS_ITERS} iterations: loss "
        f"{first_loss:.6g} -> {runs[0]['loss']:.6g}, {runs[0]['evals']} "
        f"evaluations on every rank, parameters bitwise equal on every rank; "
        f"wall per rank {walls} ms (host clock, both ranks sharing one card; "
        f"{card_line(torch)})")
    if not runs[0]["loss"] < first_loss:
        raise AssertionError(f"net_bc L-BFGS: {first_loss} -> "
                             f"{runs[0]['loss']}")
    return total


def eager_copy(model):
    """The same model with every jet on the plain (eager) path."""
    if hasattr(model, "uv_model"):  # closed-form composite
        return dataclasses.replace(
            model, uv_model=dataclasses.replace(model.uv_model, jet_impl="eager"))
    return dataclasses.replace(model, jet_impl="eager")


def http(method, url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1

    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.eval.render import predict_fields
    from pinn_elastodynamics_torch.kernels import _native
    from pinn_elastodynamics_torch.kernels import fused_jet as fj
    from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
    from pinn_elastodynamics_torch.models.fourier import FourierMLPFieldModel
    from pinn_elastodynamics_torch.models.fields import FieldSpec, SECOND_ORDER
    from pinn_elastodynamics_torch.serving import FieldEvaluator, FieldServer
    from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    t_all = time.perf_counter()

    # 1. Card.
    t0 = time.perf_counter()
    log(card_line(torch))
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    log(f"phase card: {time.perf_counter() - t0:.2f} s")

    # 2. Build.
    t0 = time.perf_counter()
    _native.library()
    log(f"phase build: {time.perf_counter() - t0:.2f} s "
        f"({_native.library_path().name})")

    # Full-width parameters (JAX layout, numpy) for both plate models.
    uv_dims = [3] + [70] * 8 + [5]
    small_dims = [3] + [20] * 4 + [5]
    four_dims = [2 * FOURIER] + [70] * 8 + [5]
    net_tree = {"uv": mlp_tree(rng, uv_dims), "dist": mlp_tree(rng, small_dims),
                "part": mlp_tree(rng, small_dims)}
    b_mat = (FOURIER_SCALE * rng.standard_normal((3, FOURIER))).astype(np.float32)
    ana_tree = {"uv": {"B": b_mat, "mlp": mlp_tree(rng, four_dims)}}
    net_p = params_from_jax(net_tree, device=dev)
    ana_p = params_from_jax(ana_tree, device=dev)
    raw_p = params_from_jax(mlp_tree(rng, uv_dims), device=dev)
    wave_p = params_from_jax(
        mlp_tree(np.random.default_rng(SEED + 1), WAVE_DIMS), device=dev)
    net_p64, ana_p64, raw_p64 = to64(net_p), to64(ana_p), to64(raw_p)
    spec = FieldSpec(ndim=2, formulation=SECOND_ORDER)
    fourier = FourierMLPFieldModel(
        spec=spec, hidden=(70,) * 8, n_features=FOURIER,
        feature_scale=FOURIER_SCALE, normalize=True, lb=plate_hole.LB,
        ub=plate_hole.UB)

    # 3. Kernels against their plain versions (float64 on the card).
    t0 = time.perf_counter()
    max_err = {"fused_mlp_jet": 0.0, "fused_composite_jet": 0.0}
    with torch.no_grad():
        for n in (N_BIG, N_RAGGED):
            x = spacetime(rng, n, torch, dev)
            x64 = x.double()
            for order in (1, 2):
                h, d, dtt = fourier._embed_jet(ana_p["uv"], x, order)
                h64, d64, dtt64 = fourier._embed_jet(ana_p64["uv"], x64, order)
                ker = fv.fused_seed_jet_vjp(ana_p["uv"]["mlp"], h, d, dtt)
                ref = fj.fused_seed_jet_reference(
                    ana_p64["uv"]["mlp"], h.double(), d.double(),
                    None if dtt is None else dtt.double())
                err = check_jet(f"B1 seeded Fourier{FOURIER} n={n} order={order}",
                                ker, ref)
                max_err["fused_mlp_jet"] = max(max_err["fused_mlp_jet"], err)

                kw = dict(order=order, lb=plate_hole.LB, ub=plate_hole.UB)
                ker = fv.fused_jet_vjp(raw_p, x, **kw)
                ref = fj.fused_jet_reference(raw_p64, x64, **kw)
                err = check_jet(f"B1 raw lb/ub n={n} order={order}", ker, ref)
                max_err["fused_mlp_jet"] = max(max_err["fused_mlp_jet"], err)

                ker = fv.fused_composite_jet_vjp(net_p, x, order=order)
                ref = fj.fused_composite_jet_reference(net_p64, x64, order=order)
                err = check_jet(f"B4 composite n={n} order={order}", ker, ref)
                max_err["fused_composite_jet"] = max(
                    max_err["fused_composite_jet"], err)
                del h64, d64, dtt64
        x = spacetime(np.random.default_rng(SEED + 2), N_RAGGED, torch, dev)
        h, d, _ = fourier._embed_jet(ana_p["uv"], x, 1)
        ker = fv.fused_seed_jet_vjp(wave_p, h, d)
        ref = fj.fused_seed_jet_reference(to64(wave_p), h.double(), d.double())
        err = check_jet(f"B1 wave-confined widths n={N_RAGGED} order=1", ker,
                        ref)
        max_err["fused_mlp_jet"] = max(max_err["fused_mlp_jet"], err)
        # The wave configurations' shapes, order 1: N = 1,000 and the
        # collocation N, through the entry the models call.
        wrng = np.random.default_rng(SEED + 4)
        for key, (dims, _, _, norm, seeded) in WAVE_SHAPES.items():
            for n in (N_RAGGED, None):
                params, x, h0, d = wave_kernel_inputs(torch, dev, wrng, key, n)
                if seeded:
                    ker = fv.fused_seed_jet_vjp(params, h0, d)
                    ref = fj.fused_seed_jet_reference(
                        to64(params), h0.double(), d.double())
                else:
                    lb, ub = norm if norm else (None, None)
                    ker = fv.fused_jet_vjp(params, x, order=1, lb=lb, ub=ub)
                    ref = fj.fused_jet_reference(to64(params), x.double(),
                                                 order=1, lb=lb, ub=ub)
                kind = ("seeded Fourier64" if seeded
                        else "lb/ub" if norm else "raw")
                err = check_jet(f"B1 {key} {kind} widths {dims[1]} "
                                f"n={x.shape[0]} order=1", ker, ref)
                max_err["fused_mlp_jet"] = max(max_err["fused_mlp_jet"], err)
    torch.cuda.synchronize()
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    # 4. Serving: both plate models behind FieldServer.
    t0 = time.perf_counter()
    models = {
        "plate_net_bc": (plate_hole.build_model(), net_p, net_p64,
                         "fused_composite_jet"),
        "plate_analytic_fourier64": (
            plate_hole.build_model(bc="analytic", fourier=FOURIER,
                                   fourier_scale=FOURIER_SCALE),
            ana_p, ana_p64, "fused_mlp_jet"),
    }
    requests = {size: plate_points(rng, size) for size in REQUEST_SIZES}
    evaluators, servers, answers, grown = {}, {}, {}, {}
    try:
        for name, (model, params, _, _) in models.items():
            ev = FieldEvaluator(model, params, name=name, device="cuda").warmup()
            evaluators[name] = ev
            servers[name] = FieldServer(ev).start()
        fj.reset_launches()
        for name, server in servers.items():
            before = dict(fj.LAUNCHES)
            host, port = server.address
            base = f"http://{host}:{port}"
            code, body = http("GET", base + "/healthz")
            assert code == 200 and body["status"] == "ok", body
            code, meta = http("GET", base + "/meta")
            assert code == 200 and meta["name"] == name, meta
            assert meta["channels"] == list(spec.channels), meta
            for size, xy in requests.items():
                code, body = http("POST", base + "/predict",
                                  {"points": xy.tolist(), "t": T_SERVE})
                assert code == 200 and body["n"] == size, (code, body.get("n"))
                answers[name, size] = body["fields"]
            grown[name] = {k: fj.LAUNCHES[k] - before[k] for k in fj.LAUNCHES}
        launches = dict(fj.LAUNCHES)
    finally:
        for server in servers.values():
            server.stop()
    log(f"  launches while serving: {launches} (per model {grown})")
    for name, (_, _, _, kernel) in models.items():
        if grown[name][kernel] < 1:
            raise AssertionError(f"{name} did not launch {kernel}")
    for kernel, count in launches.items():
        if count < 1:
            raise AssertionError(f"{kernel} was not launched while serving")

    for name, (model, _, params64, _) in models.items():
        eager = eager_copy(model)
        for size, xy in requests.items():
            direct = evaluators[name].evaluate(xy, T_SERVE)
            got = answers[name, size]
            plain = predict_fields(eager, params64, xy.astype(np.float64),
                                   T_SERVE, dtype=np.float64, device="cuda")
            worst_http = worst_plain = 0.0
            for field, ref in direct.items():
                resp = np.asarray(got[field], np.float64)
                scale = max(1.0, float(np.abs(ref).max()))
                worst_http = max(worst_http,
                                 float(np.abs(resp - ref).max()) / scale)
                pscale = max(1.0, float(np.abs(plain[field]).max()))
                worst_plain = max(worst_plain, float(
                    np.abs(ref.astype(np.float64) - plain[field]).max()) / pscale)
            log(f"  {name} n={size}: http vs direct {worst_http:.3e}, "
                f"direct vs plain f64 {worst_plain:.3e}")
            if not worst_http <= 1e-6:
                raise AssertionError(f"{name} n={size}: answer differs from "
                                     f"direct evaluation by {worst_http:.3e}")
            if not worst_plain <= TOL_FD:
                raise AssertionError(f"{name} n={size}: direct evaluation "
                                     f"differs from plain f64 by {worst_plain:.3e}")
    log(f"phase serving: {time.perf_counter() - t0:.2f} s")

    # 5. Timings at N = 65,536, order 1 (serving), and of B1 and B4 at
    # N = 103,711, order 2 (the shape training launches).
    t0 = time.perf_counter()
    mlp = ana_p["uv"]["mlp"]
    weight_bytes = {
        "fused_mlp_jet": sum(t.numel() * 4 for layer in mlp
                             for t in layer.values()),
        "fused_composite_jet": sum(t.numel() * 4 for net in net_p.values()
                                   for layer in net for t in layer.values()),
    }
    replaces = {
        "fused_mlp_jet": "pinn_elastodynamics_tpu/kernels/fused_jet.py:116",
        "fused_composite_jet":
            "pinn_elastodynamics_tpu/kernels/fused_jet.py:125",
    }

    def forward_timed(n, order):
        """name -> (kernel, plain, flops, bytes) at n points, this order."""
        s = 3 + order
        x = spacetime(rng, n, torch, dev)
        h, d, dtt = fourier._embed_jet(ana_p["uv"], x, order)
        seed = (h, d, dtt)[:2 if order == 1 else 3]
        out_bytes = 4 * s * n * 5
        return {
            "fused_mlp_jet": (
                lambda: fj.fused_seed_jet_stack(mlp, *seed),
                lambda: fj.fused_seed_jet_reference(mlp, *seed),
                flops_per_point(four_dims, s) * n,
                4 * sum(t.numel() for t in seed) + out_bytes
                + weight_bytes["fused_mlp_jet"]),
            "fused_composite_jet": (
                lambda: fj.fused_composite_jet_stack(net_p, x, order=order),
                lambda: fj.fused_composite_jet_reference(net_p, x,
                                                         order=order),
                sum(flops_per_point(dims, s)
                    for dims in (uv_dims, small_dims, small_dims)) * n,
                4 * x.numel() + out_bytes
                + weight_bytes["fused_composite_jet"]),
        }

    with torch.no_grad():
        serve = {name: time_kernel(torch, name, *args, f"n={N_BIG} order=1")
                 for name, args in forward_timed(N_BIG, 1).items()}
        train = {name: time_kernel(torch, name, *args, f"n={N_TRAIN} order=2")
                 for name, args in forward_timed(N_TRAIN, 2).items()}
        # B1 at the wave configurations' collocation shapes (order 1).
        wrng = np.random.default_rng(SEED + 5)
        wave_fwd = {}
        for key, (dims, n, _, norm, seeded) in WAVE_SHAPES.items():
            params, x, h0, d = wave_kernel_inputs(torch, dev, wrng, key)
            lb, ub = norm if norm else (None, None)
            if seeded:
                kern = lambda: fj.fused_seed_jet_stack(params, h0, d)
                plain = lambda: fj.fused_seed_jet_reference(params, h0, d)
                in_bytes = 4 * (h0.numel() + d.numel())
            else:
                kern = lambda: fj.fused_jet_stack(params, x, order=1, lb=lb,
                                                  ub=ub)
                plain = lambda: fj.fused_jet_reference(params, x, order=1,
                                                       lb=lb, ub=ub)
                in_bytes = 4 * x.numel()
            s_w = shape_streams(key)
            wave_fwd[key] = time_kernel(
                torch, "fused_mlp_jet", kern, plain,
                flops_per_point(dims, s_w) * n,
                in_bytes + 4 * s_w * n * dims[-1] + 4 * n_params(params),
                f"{key} n={n} order=1")
    kernels = [{
        "name": name, "route": "cuda",
        "source": "pinn_elastodynamics_torch/kernels/csrc/fused_jet.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": max_err[name], **serve[name],
        f"n{N_TRAIN}_order2": train[name], "library_ms": None,
    } for name in serve]
    kernels[0]["wave_shapes"] = wave_fwd
    assert kernels[0]["name"] == "fused_mlp_jet"
    xy = plate_points(rng, 4 * N_BIG)
    for name, ev in evaluators.items():
        model, params = ev.model, ev.params
        predict_fields(model, params, xy, T_SERVE, device="cuda")
        runs = []
        for _ in range(5):
            s = time.perf_counter()
            predict_fields(model, params, xy, T_SERVE, device="cuda")
            runs.append(time.perf_counter() - s)
        sec = float(np.median(runs))
        log(f"  predict_fields {name}: {xy.shape[0]} points in {sec:.4f} s, "
            f"{xy.shape[0] / sec:.0f} points/s (chunk 65536, median of 5)")
        wall, busy, rows = device_breakdown(
            torch, lambda: predict_fields(model, params, xy, T_SERVE,
                                          device="cuda"))
        log(f"  profiled {name}: wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%)")
        for sec_k, count, key in rows:
            log(f"    {sec_k:.5f} s  x{count}  {key[:90]}")
    log(f"phase timings: {time.perf_counter() - t0:.2f} s")

    # 6. Backward kernels against their plain versions (float64 on the card).
    t0 = time.perf_counter()
    bwd_err = backward_checks(torch, dev, rng, (net_p, ana_p, raw_p), fourier,
                              wave_p)
    torch.cuda.synchronize()
    log(f"phase backward kernels: {time.perf_counter() - t0:.2f} s")

    # 7. Training at full width and full bank scale.
    t0 = time.perf_counter()
    trees = (net_p, ana_p, {"uv": raw_p})
    trained = training_checks(torch, dev, trees)
    train_launches = {k: sum(t["launches"][k] for t in trained.values())
                      for k in next(iter(trained.values()))["launches"]}
    log(f"  launches over the three value+grads: {train_launches}")
    for k in kernels:   # forward kernels: serving and training
        k["launches"] += train_launches[k["name"]]
    log(f"phase training: {time.perf_counter() - t0:.2f} s")

    # 8. Backward timings, value+grad timings and profiles.
    t0 = time.perf_counter()
    kernels += backward_timings(torch, dev, rng, (net_p, ana_p, raw_p),
                                fourier, trained, bwd_err, train_launches)
    log(f"phase training timings: {time.perf_counter() - t0:.2f} s")

    # 9. L-BFGS on each configuration's main phase.
    t0 = time.perf_counter()
    lbfgs_launches = lbfgs_checks(torch, trained)
    log(f"phase lbfgs: {time.perf_counter() - t0:.2f} s")

    # 10. The net-BC pipeline with checkpoint and resume.
    t0 = time.perf_counter()
    pipe_launches = pipeline_checks(torch, dev, net_p)
    log(f"phase pipeline: {time.perf_counter() - t0:.2f} s")

    # 11. The wave configurations at full width and scale 1.0.
    t0 = time.perf_counter()
    wave_launches = wave_checks(torch, dev)
    log(f"phase waves: {time.perf_counter() - t0:.2f} s")

    # 12. The time-horizon curriculum and the CLI.
    t0 = time.perf_counter()
    curriculum_launches = curriculum_checks(torch, dev)
    log(f"phase curriculum and CLI: {time.perf_counter() - t0:.2f} s")

    # 13. The microbatched million-point loss.
    t0 = time.perf_counter()
    million_launches = million_checks(torch, dev)
    log(f"phase million: {time.perf_counter() - t0:.2f} s")

    # 14. The extended-precision endgame.
    t0 = time.perf_counter()
    endgame_launches = endgame_checks(torch, dev, trees)
    log(f"phase endgame: {time.perf_counter() - t0:.2f} s")

    # 15. The 3D case, its MMS case and the 3D CLI.
    t0 = time.perf_counter()
    elastic3d_launches = elastic3d_checks(torch, dev)
    log(f"phase elastic3d: {time.perf_counter() - t0:.2f} s")

    # 16. The FEM comparison on synthetic frames, and --compare-fem.
    t0 = time.perf_counter()
    fem_launches = fem_checks(torch, dev, net_p)
    log(f"phase fem: {time.perf_counter() - t0:.2f} s")

    # 17. The inverse problem at full width.
    t0 = time.perf_counter()
    inverse_launches, inverse_times = inverse_checks(torch, dev)
    log(f"phase inverse: {time.perf_counter() - t0:.2f} s")

    # 18. Residual-driven resampling.
    t0 = time.perf_counter()
    adaptive_launches = adaptive_checks(torch, dev)
    log(f"phase adaptive: {time.perf_counter() - t0:.2f} s")

    # 19. Native point generation.
    t0 = time.perf_counter()
    native_checks()
    log(f"phase native: {time.perf_counter() - t0:.2f} s")

    # 20. Data parallelism over the points axis.
    t0 = time.perf_counter()
    mesh_launches = mesh_checks(torch, dev)
    log(f"phase mesh: {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        k["launches"] += sum(counts[k["name"]] for counts in (
            lbfgs_launches, pipe_launches, wave_launches,
            curriculum_launches, million_launches, endgame_launches,
            elastic3d_launches, fem_launches, inverse_launches,
            adaptive_launches, mesh_launches))
        if k["name"] in inverse_times:
            k.update(inverse_times[k["name"]])
            k["max_abs_err"] = max(k["max_abs_err"],
                                   k["inverse_order2"]["max_abs_err"])
    log(f"total: {time.perf_counter() - t_all:.2f} s")
    log(card_line(torch))   # again, beside the numbers at the end

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
