"""The readings that the limits of ``correct`` are set from.

    python3 -m benchmark.study --workload <cell> --seeds 12 --control 3 \\
        --faults half_batch:3 [--seconds 3] [--first-seed 1000]

runs, in one process on the card, the cell's check on ``--seeds`` seeds of
the program, on ``--control`` seeds of the control (the reference in TF32
put in the program's place) and on the given seeds of each planted fault,
and prints one JSON line per run with its readings.  Each run sets up as
the benchmark does and measures a window of ``--seconds`` (``--seconds``
of the control's and the faults' runs are ``--other-seconds``, if given):
a training run's check reads the first steps and the window's end, a
serving run's the answers of its window.  The limits of
``benchmark/limits/<cell>.json`` are not read.
"""

import argparse
import gc
import json
import sys
import time

from benchmark import run as bench_run


class _AnyLimit(dict):
    def __missing__(self, key):
        return float("inf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[],
                   help="name:seeds, e.g. half_batch:3")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--other-seconds", type=float, default=None)
    p.add_argument("--first-seed", type=int, default=1000)
    args = p.parse_args(argv)
    import torch

    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    plan = [("program", None, args.seeds), ("control", None, args.control)]
    for item in args.faults:
        name, n = item.split(":")
        plan.append(("fault", name, int(n)))
    seed = args.first_seed
    for kind, fault, n in plan:
        seconds = (args.seconds if kind == "program"
                   or args.other_seconds is None else args.other_seconds)
        for _ in range(n):
            t0 = time.perf_counter()
            run = bench_run.open_run(bench, args.workload, seed, seconds,
                                     False, t0, limits=_AnyLimit())
            if run is None:
                return 2
            bench_run.execute(run, bench, fault=fault,
                              control=kind == "control")
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "fault": fault, "seed": seed,
                              "readings": {k: v for k, (v, _)
                                           in run.checks.items()},
                              "seconds": time.perf_counter() - t0,
                              "setup_s": run.setup_s,
                              "counts": {k: v for k, v in run.counts.items()
                                         if k in ("checked_requests",
                                                  "leaves_left_out", "iters",
                                                  "evals", "window_pairs")}}),
                  flush=True)
            seed += 1
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
