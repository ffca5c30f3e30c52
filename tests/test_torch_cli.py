"""PyTorch port: the CLI driver (``python -m pinn_elastodynamics_torch.run``)
on the CPU."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from pinn_elastodynamics_torch import run as cli
from pinn_elastodynamics_torch.train import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_plate_hole_tiny(tmp_path):
    out = str(tmp_path / "run")
    rc = cli.main([
        "--case", "plate_hole", "--scale", "0.002", "--out", out,
        "--maxiter", "dist=5", "part=5", "uv=5",
        "--log-every", "0", "--device", "cpu",
    ])
    assert rc == 0
    events = _events(out)
    names = [e["event"] for e in events]
    assert "start" in names and "train_done" in names
    assert names.count("phase_end") == 3
    start = events[names.index("start")]
    assert start["devices"] == ["cpu"] and start["dtype"] == "float32"
    # Reference-compatible uv export.
    with open(os.path.join(out, "plate_hole_quarter_uv.pickle"), "rb") as f:
        w, b = pickle.load(f)
    assert w[0].shape == (3, 70) and b[-1].shape == (1, 5)
    # Native phase checkpoints.
    assert os.path.exists(os.path.join(out, "plate_hole_quarter_uv.ckpt"))


def test_cli_wave_case_and_warm_start(tmp_path):
    """wave_confined trains its one phase; a second run warm-starts from
    the first run's reference pickle and starts from its loss."""
    out = str(tmp_path / "wave")
    rc = cli.main([
        "--case", "wave_confined", "--scale", "0.002", "--out", out,
        "--maxiter", "uv=4", "--segment", "2", "--log-every", "0",
        "--device", "cpu", "--max-t", "7",
    ])
    assert rc == 0
    events = _events(out)
    (phase_end,) = [e for e in events if e["event"] == "phase_end"]
    (done,) = [e for e in events if e["event"] == "train_done"]
    assert phase_end["phase"] == "uv" and phase_end["iters"] == 4
    assert sorted(done["components"]) == ["FIX", "IC", "SRC", "f_s", "f_uv"]
    assert all(np.isfinite(v) for v in done["components"].values())
    pickle_path = os.path.join(out, "elastic_wave_confined_uv.pickle")
    params = tckpt.load_reference_pickle(pickle_path, device="cpu")
    assert [tuple(l["W"].shape) for l in params] == (
        [(3, 140)] + [(140, 140)] * 5 + [(140, 7)])
    assert os.path.exists(os.path.join(out, "elastic_wave_confined_uv.ckpt"))

    out2 = str(tmp_path / "warm")
    assert cli.main([
        "--case", "wave_confined", "--scale", "0.002", "--out", out2,
        "--maxiter", "uv=1", "--log-every", "0", "--device", "cpu",
        "--max-t", "7", "--warm-start", pickle_path,
    ]) == 0
    (warm,) = [e for e in _events(out2) if e["event"] == "phase_end"]
    assert warm["final_loss"] <= phase_end["final_loss"]


def test_cli_resume_continues_the_live_checkpoint(tmp_path):
    """A run cut short leaves its live checkpoint; ``--resume`` continues
    from it and ends where the uncut run ends."""
    base = ["--case", "wave_infinite", "--scale", "0.002", "--segment", "2",
            "--log-every", "0", "--device", "cpu", "--max-t", "10"]
    cut = str(tmp_path / "cut")
    # The live checkpoint is written every 10 segments: a budget of 20
    # iterations leaves one at iteration 20; resume to 24 against 24.
    assert cli.main(base + ["--out", cut, "--maxiter", "uv=20"]) == 0
    live = tckpt.load_checkpoint(
        os.path.join(cut, "elastic_wave_infinite_live.ckpt"))
    assert live["phase"] == "uv" and live["iters"] == 20
    assert cli.main(base + ["--out", cut, "--maxiter", "uv=24",
                            "--resume"]) == 0
    full = str(tmp_path / "full")
    assert cli.main(base + ["--out", full, "--maxiter", "uv=24"]) == 0
    (resumed,) = [e for e in _events(cut) if e["event"] == "phase_end"][1:]
    (want,) = [e for e in _events(full) if e["event"] == "phase_end"]
    assert resumed["iters"] == 4
    assert resumed["final_loss"] == want["final_loss"]


@pytest.mark.parametrize("bad", ["uv", "uv=", "uv=x", "uv=-1", "uv=2.5"])
def test_cli_maxiter_parse_errors(tmp_path, bad):
    with pytest.raises(SystemExit, match="--maxiter expects PHASE=N"):
        cli.main(["--case", "wave_confined", "--scale", "0.002",
                  "--device", "cpu", "--out", str(tmp_path),
                  "--maxiter", bad])


@pytest.mark.parametrize("flag, message", [
    (["--compare-fem"], "no FEM frames (ProbeData-0.mat) in "),
    (["--plots", "4"], "--plots needs the 'matplotlib' package")])
def test_cli_flags_not_ported_exit_nonzero(tmp_path, capsys, monkeypatch,
                                           flag, message):
    """``--compare-fem`` and ``--plots`` exit 2 before training when they
    cannot run: no FEM frames under ``--fem-root``, or (``--plots``) no
    matplotlib."""
    import sys

    from pinn_elastodynamics_torch import eval as eval_pkg

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "pinn_elastodynamics_torch.eval.plots",
                        raising=False)
    monkeypatch.delattr(eval_pkg, "plots", raising=False)
    out = str(tmp_path / "out")
    rc = cli.main(["--case", "wave_confined", "--scale", "0.002",
                   "--device", "cpu", "--out", out,
                   "--fem-root", str(tmp_path)] + flag)
    assert rc == 2
    assert message in capsys.readouterr().err
    assert not os.path.exists(out)


def test_cli_rejects_cases_not_ported(capsys):
    """The inverse case is no ``--case`` of the CLI, as in JAX."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--case", "inverse", "--device", "cpu"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_cli_elastic3d_on_the_cpu(tmp_path):
    """The 3D case trains its one phase through the CLI and exports its
    4 -> 100 x 6 -> 12 net as a reference pickle."""
    out = str(tmp_path / "3d")
    assert cli.main(["--case", "elastic3d", "--scale", "0.001", "--out", out,
                     "--maxiter", "uv=3", "--segment", "2", "--log-every",
                     "0", "--device", "cpu"]) == 0
    events = _events(out)
    (start,) = [e for e in events if e["event"] == "start"]
    (phase_end,) = [e for e in events if e["event"] == "phase_end"]
    (done,) = [e for e in events if e["event"] == "train_done"]
    assert start["case"] == "elastic_wave_3d" and start["devices"] == ["cpu"]
    assert phase_end["phase"] == "uv" and phase_end["iters"] == 4
    assert sorted(done["components"]) == ["IC", "SRC", "f_s", "f_uv"]
    assert all(np.isfinite(v) for v in done["components"].values())
    params = tckpt.load_reference_pickle(
        os.path.join(out, "elastic_wave_3d_uv.pickle"), device="cpu")
    assert [tuple(l["W"].shape) for l in params] == (
        [(4, 100)] + [(100, 100)] * 5 + [(100, 12)])


def test_cli_defaults_to_the_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["--case", "wave_confined", "--scale", "0.002",
                  "--out", str(tmp_path)])


def test_cli_x64_on_the_cpu_trains_in_float64(tmp_path):
    out = str(tmp_path / "x64")
    assert cli.main(["--case", "wave_semi_infinite", "--scale", "0.002",
                     "--device", "cpu", "--x64", "--out", out,
                     "--maxiter", "uv=2", "--log-every", "0"]) == 0
    (start,) = [e for e in _events(out) if e["event"] == "start"]
    assert start["dtype"] == "float64" and start["jet_impl"] == "auto"
    state = tckpt.load_checkpoint(
        os.path.join(out, "elastic_wave_semi_infinite_uv.ckpt"))
    assert state["params"][0]["W"].dtype == np.float64


def test_cli_x64_on_cuda_builds_the_eager_route(monkeypatch, tmp_path):
    """On a CUDA device ``--x64`` asks the builder for float64 banks and the
    eager jets (the kernels are float32 only), before anything runs."""
    from pinn_elastodynamics_torch import device as device_mod
    from pinn_elastodynamics_torch.cases import wave_confined

    class Built(Exception):
        pass

    seen = {}

    def build(**kw):
        seen.update(kw)
        raise Built

    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(wave_confined, "build", build)
    with pytest.raises(Built):
        cli.main(["--case", "wave_confined", "--x64", "--out",
                  str(tmp_path)])
    assert seen["jet_impl"] == "eager" and seen["dtype"] == torch.float64
    assert seen["device"] == torch.device("cuda")
    assert seen["pad_to_multiple_of"] == 1
    seen.clear()
    with pytest.raises(Built):
        cli.main(["--case", "wave_confined", "--out", str(tmp_path)])
    assert "jet_impl" not in seen and seen["dtype"] == torch.float32


def test_metric_logger_and_phase_timer_match_jax(tmp_path):
    """The JSONL records of the port's logger have the JAX logger's keys
    and values (numpy scalars and arrays included)."""
    from pinn_elastodynamics_tpu.utils import logging as jlog
    from pinn_elastodynamics_torch.utils import logging as tlog

    records = []
    for mod, name in ((jlog, "jax"), (tlog, "torch")):
        path = tmp_path / f"{name}.jsonl"
        with mod.MetricLogger(str(path)) as logger:
            logger.log({"event": "x", "n": np.int64(3),
                        "v": np.float32(0.5), "a": np.arange(3)})
            with mod.PhaseTimer(logger, "stage"):
                pass
        records.append([json.loads(line) for line in open(path)])
    jrec, trec = records
    for j, t in zip(jrec, trec, strict=True):
        assert sorted(j) == sorted(t)
        for k in j:
            if k not in ("t", "seconds"):
                assert j[k] == t[k]
    assert trec[1]["event"] == "phase_time" and trec[1]["seconds"] >= 0
