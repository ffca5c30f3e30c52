"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; it names a configuration (``benchmark/configs/<name>.json``,
whose ``adapter`` is a module of ``benchmark/adapters``) and a traffic mix
(``benchmark/traffic/<mix>.json``, whose ``driver`` is a module of
``benchmark/drivers``).  Each metric that the cell reports is read by
``benchmark/metrics/<metric>.py``; the limits of the numbers that decide
``correct`` are in ``benchmark/limits/<cell>.json``.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
traced run.

The run needs as many CUDA cards as the cell asks for and fails, printing
no result, without them.  It fails too if JAX or the JAX package was
loaded.  The last lines of standard error give each compared number beside
its limit; the last line of standard output is the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str):
    """(cell, config, traffic, limits) of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / config["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{name}.json"))


def metric_names(bench: dict, cell: str, trace: bool):
    """(name, unit) of every metric this cell reports at this ``trace``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if "workloads" not in m or cell in m["workloads"]]


def seed_of(seed: int) -> int:
    """The seed as the generators take it (a non-negative integer)."""
    return seed % (1 << 63)


def open_run(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, limits=None):
    """The run of ``workload`` on the first card: the program's arithmetic
    set (exact float32 products, no TF32) and the cell's files read;
    ``limits`` in place of the cell's own, if given.  None, with the
    reason on standard error, when the cards the cell asks for are not
    there."""
    import torch

    from benchmark.core import Run

    cell, config, traffic, cell_limits = cell_files(bench, workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return None
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Run(cell=cell, config=config, traffic=traffic,
               seed=seed_of(seed), seconds=seconds, trace=trace,
               device=torch.device("cuda", 0), chips=cell["chips"],
               t_start=t_start,
               limits=cell_limits if limits is None else limits)


def execute(run, bench: dict, **drive_kw) -> dict:
    """Drive the run's cell and read its metrics: (name -> (value, unit)),
    leaving out a metric whose reader found nothing (or, with failed
    requests, no finite value; ``correct`` is then false)."""
    from benchmark.core import metric_reader

    adapter = importlib.import_module(
        f"benchmark.adapters.{run.config['adapter']}")
    driver = importlib.import_module(
        f"benchmark.drivers.{run.traffic['driver']}")
    driver.drive(run, adapter, **drive_kw)
    out = {}
    for name, unit in metric_names(bench, run.cell["name"], run.trace):
        value = metric_reader(name)(run)
        if value is not None and math.isfinite(value):
            out[name] = (float(value), unit)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.core import forbidden_loaded, print_checks, result_line

    bench = load_json(ROOT / "BENCHMARK.json")
    run = open_run(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START)
    if run is None:
        return 2
    metrics = execute(run, bench)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print("window: " + json.dumps(
        {k: run.counts[k] for k in ("evals", "iters", "points", "launches")
         if k in run.counts} | {"seconds": run.window_s,
                                "requests": run.attempted}),
          file=sys.stderr)
    print_checks(run)
    print(result_line(run, metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
