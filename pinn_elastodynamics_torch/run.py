"""Command-line experiment driver.

Counterpart of ``pinn_elastodynamics_tpu/run.py``: one entry point in place
of the reference's four hand-edited ``__main__`` blocks.

    python -m pinn_elastodynamics_torch.run --case plate_hole \
        --maxiter uv=2000 dist=500 part=500 --out runs/plate

It runs the case's full phase pipeline (dist → part → uv where
applicable), streams JSONL metrics, and checkpoints each phase atomically
(native format + reference-compatible pickles), and optionally scores the
trained fields against the FEM frames (``--compare-fem``) and renders
comparison figures (``--plots``, which needs matplotlib).  The case's FEM
directory is read under ``--fem-root``, the root of the reference project.
It runs on ``--device``, ``cuda`` unless the CPU is asked for.  The CUDA
kernels compute in float32, so ``--x64`` on a CUDA device builds the case
with the plain (eager) jets.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

CASES = {
    "plate_hole": "pinn_elastodynamics_torch.cases.plate_hole",
    "wave_confined": "pinn_elastodynamics_torch.cases.wave_confined",
    "wave_infinite": "pinn_elastodynamics_torch.cases.wave_infinite",
    "wave_semi_infinite": "pinn_elastodynamics_torch.cases.wave_semi_infinite",
    "elastic3d": "pinn_elastodynamics_torch.cases.elastic3d",
}


def parse_kv_ints(items):
    out = {}
    for it in items or []:
        k, sep, v = it.partition("=")
        if not sep or not v.isdigit():
            raise SystemExit(
                f"error: --maxiter expects PHASE=N (e.g. uv=2000), got {it!r}"
            )
        out[k] = int(v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", choices=sorted(CASES), required=True)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="point-count scale factor (1.0 = reference scale)")
    ap.add_argument("--seed", type=int, default=1111)
    ap.add_argument("--max-t", type=float, default=None,
                    help="time horizon override (curriculum stages)")
    ap.add_argument("--maxiter", nargs="*", default=None,
                    metavar="PHASE=N", help="per-phase L-BFGS budget")
    ap.add_argument("--warm-start", default=None,
                    help="checkpoint (native or reference pickle) to resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the live checkpoint in --out "
                         "(skips completed phases; restores L-BFGS state)")
    ap.add_argument("--out", default="runs/out")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--segment", type=int, default=100,
                    help="L-BFGS iterations per segment (the live "
                         "checkpoint is written between segments)")
    ap.add_argument("--x64", action="store_true",
                    help="float64; on a CUDA device the jets run eager, "
                         "since the kernels are float32 only")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; pass cpu "
                         "for the CPU)")
    ap.add_argument("--fourier", type=int, default=0,
                    help="random-Fourier-feature count on the uv net "
                         "(builder knob; 0 = plain MLP)")
    ap.add_argument("--fourier-scale", type=float, default=1.0)
    ap.add_argument("--bc", default=None, choices=("net", "analytic"),
                    help="plate only: 'analytic' = exact closed-form D/P "
                         "composite (models/analytic_bc.py)")
    ap.add_argument("--compare-fem", action="store_true")
    ap.add_argument("--plots", type=int, default=0,
                    help="render N comparison frames")
    ap.add_argument("--fem-root", default=".",
                    help="root of the reference project, under which the "
                         "case's FEM frames lie (default: the current "
                         "directory)")
    args = ap.parse_args(argv)

    if args.plots:
        try:
            from .eval import plots   # imports matplotlib
        except ModuleNotFoundError as e:
            print(f"error: --plots needs the {e.name!r} package, which is "
                  "not installed", file=sys.stderr)
            return 2

    from .cases.base import run_pipeline
    from .device import resolve_device
    from .eval import compare, fem
    from .train import checkpoint as ckpt
    from .utils.logging import MetricLogger

    device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    mod = importlib.import_module(CASES[args.case])
    build_kwargs = dict(scale=args.scale, seed=args.seed, dtype=dtype,
                        pad_to_multiple_of=1, device=device)
    # The kernels take float32 only: float64 on the card is the eager route.
    eager_x64 = args.x64 and device.type == "cuda"
    if eager_x64:
        build_kwargs["jet_impl"] = "eager"
    if args.max_t is not None:
        build_kwargs["max_t"] = args.max_t
    if args.fourier:
        build_kwargs.update(fourier=args.fourier,
                            fourier_scale=args.fourier_scale)
    if args.bc is not None:
        build_kwargs["bc"] = args.bc
    case = mod.build(**build_kwargs)
    if (args.compare_fem or args.plots) and case.fem_dir:
        fem_dir = compare.fem_path(case, args.fem_root)
        if fem.frame_count(fem_dir) == 0:
            print(f"error: no FEM frames (ProbeData-0.mat) in {fem_dir}; "
                  "pass --fem-root", file=sys.stderr)
            return 2

    os.makedirs(args.out, exist_ok=True)
    logger = MetricLogger(os.path.join(args.out, "metrics.jsonl"), echo=True)
    logger.log({
        "event": "start", "case": case.name, "scale": args.scale,
        "devices": [str(device)],
        "dtype": str(dtype).replace("torch.", ""),
        "jet_impl": "eager" if eager_x64 else "auto",
        "banks": {k: b.n_total for k, b in case.banks.items()},
    })

    params = None
    if args.warm_start:
        if args.warm_start.endswith(".pickle"):
            params = ckpt.load_reference_pickle(args.warm_start,
                                                device=device, dtype=dtype)
        else:
            state = ckpt.load_checkpoint(args.warm_start)
            state = state["params"] if "params" in state else state
            params = ckpt.params_from_jax(state, device=device, dtype=dtype)

    def on_phase_end(phase, params_now, res):
        logger.log({
            "event": "phase_end", "phase": phase.name,
            "iters": int(res.n_iters), "final_loss": float(res.final_loss),
        })
        ckpt.save_checkpoint(
            os.path.join(args.out, f"{case.name}_{phase.name}.ckpt"),
            {"params": params_now},
        )

    t0 = time.perf_counter()
    params, results = run_pipeline(
        case, params, seed=args.seed, dtype=dtype,
        log_every=args.log_every,
        maxiter_override=parse_kv_ints(args.maxiter),
        on_phase_end=on_phase_end,
        checkpoint_path=os.path.join(args.out, f"{case.name}_live.ckpt"),
        segment=args.segment,
        resume=args.resume,
    )
    logger.log({
        "event": "train_done",
        "wall_seconds": time.perf_counter() - t0,
        "components": case.components(params),
    })

    # Reference-compatible export of the main network (plain-MLP layouts
    # only — Fourier-feature params have no [W, b] reference equivalent).
    uv = params["uv"] if isinstance(params, dict) and "uv" in params else params
    if not (isinstance(uv, dict) and "B" in uv):
        ckpt.save_reference_pickle(
            os.path.join(args.out, f"{case.name}_uv.pickle"), uv
        )

    if args.compare_fem and case.fem_dir:
        frames = list(range(0, case.n_frames, max(1, case.n_frames // 16)))
        cmp = compare.compare_frames(
            case, params, frames, fem_root=args.fem_root,
            dtype=np.float64 if args.x64 else np.float32)
        logger.log({"event": "fem_errors", **cmp["aggregate"]})
        logger.log({"event": "fem_errors_mid", **cmp["aggregate_mid"]})
        with open(os.path.join(args.out, "fem_errors.json"), "w") as f:
            json.dump(cmp, f, indent=2, default=float)

    if args.plots and case.fem_dir:
        frames = list(
            range(0, case.n_frames, max(1, case.n_frames // args.plots))
        )[: args.plots]
        paths = plots.frame_sequence(case, params,
                                     os.path.join(args.out, "plots"), frames,
                                     fem_root=args.fem_root)
        logger.log({"event": "plots", "n": len(paths)})

    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
