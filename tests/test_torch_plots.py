"""PyTorch port: the comparison figures (``eval/plots.py``) and the CLI's
``--plots`` on the CPU, from synthetic FEM frames written with
``scipy.io.savemat``: each figure is a PNG of more than 1,000 bytes, and a
PNG sequence assembles into a GIF."""

import functools
import json
import os

import numpy as np
import pytest
import scipy.io
import torch

from pinn_elastodynamics_torch import run as cli
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.eval import plots as tplots
from pinn_elastodynamics_torch.eval import render as trender
from pinn_elastodynamics_torch.train import checkpoint as tckpt

FRAMES = (0, 10, 20, 30, 40)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Render in chunks of 1,024 points (the default pads every call to
    65,536)."""
    monkeypatch.setattr(tplots, "predict_fields", functools.partial(
        trender.predict_fields, chunk=1024))


@pytest.fixture(scope="module")
def fem_root(tmp_path_factory):
    """The plate's frames 0-40 (every 10th) under a reference-project root:
    smooth synthetic fields at quarter-plate probes and a ring on the
    r = 0.1 hole arc."""
    root = str(tmp_path_factory.mktemp("ref"))
    fem_dir = os.path.join(root, tplate.FEM_DIR)
    os.makedirs(fem_dir)
    rng = np.random.default_rng(8)
    xy = rng.uniform(0.0, 0.5, (1500, 2))
    xy = xy[np.hypot(xy[:, 0], xy[:, 1]) > 0.1][:600]
    th = np.linspace(0.0, np.pi / 2, 30)
    xy = np.concatenate([xy, 0.1 * np.stack([np.cos(th), np.sin(th)], 1)])
    x, y = xy[:, :1], xy[:, 1:]
    for i in range(0, 41, 10):
        a = np.sin(0.7 * i * 0.125)
        scipy.io.savemat(os.path.join(fem_dir, f"ProbeData-{i}.mat"), {
            "x": x, "y": y, "u": 1e-3 * a * np.sin(3 * x + y),
            "v": 1e-3 * a * np.cos(x - 2 * y), "s11": a * (1 + x * y),
            "s22": a * np.cos(x + y), "s12": 0.3 * a * np.sin(x * y)})
    return root


@pytest.fixture(scope="module")
def plate():
    case = tplate.build(scale=0.002, device="cpu")
    host = tckpt.load_checkpoint("runs/plate_v2/hybrid_best.ckpt")["params"]
    return case, tckpt.params_from_jax(host, device="cpu")


def _png(path):
    assert path.endswith(".png") and os.path.getsize(path) > 1000
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_frame_sequence_and_gif(plate, fem_root, tmp_path):
    case, params = plate
    out = str(tmp_path / "seq")
    paths = tplots.frame_sequence(case, params, out, FRAMES[1:4],
                                  fem_root=fem_root, deform_scale=5.0)
    assert [os.path.basename(p) for p in paths] == [
        "comparison_0010.png", "comparison_0020.png", "comparison_0030.png"]
    for p in paths:
        _png(p)
    gif = tplots.assemble_gif(paths, str(tmp_path / "seq.gif"), fps=4)
    assert os.path.getsize(gif) > 1000
    with open(gif, "rb") as f:
        assert f.read(6) == b"GIF89a"
    one = tplots.comparison_figure(case, params, 0, out, fields=("u",),
                                   fem_root=fem_root)
    _png(one)


def test_hole_edge_residual_and_loss_figures(plate, fem_root, tmp_path):
    case, params = plate
    _png(tplots.hole_edge_stress_figure(case, params,
                                        str(tmp_path / "hole.png"),
                                        fem_root=fem_root))
    _png(tplots.residual_map_figure(case, params, 2.5,
                                    str(tmp_path / "res.png")))
    hist = {"total": np.geomspace(1.0, 1e-3, 50),
            "f_s": np.geomspace(0.5, 1e-4, 50)}
    _png(tplots.loss_history_figure(hist, str(tmp_path / "loss.png")))


def test_cli_plots(fem_root, tmp_path):
    """``--plots 3`` renders three comparison frames of the trained plate
    and logs a ``plots`` event."""
    out = str(tmp_path / "run")
    # 81 frames // 3 = every 27th: 0, 27, 54; write those three too.
    src = os.path.join(fem_root, tplate.FEM_DIR, "ProbeData-10.mat")
    root = str(tmp_path / "ref")
    fem_dir = os.path.join(root, tplate.FEM_DIR)
    os.makedirs(fem_dir)
    for i in (0, 27, 54):
        with open(src, "rb") as f, open(
                os.path.join(fem_dir, f"ProbeData-{i}.mat"), "wb") as g:
            g.write(f.read())
    assert cli.main(["--case", "plate_hole", "--scale", "0.002", "--out",
                     out, "--maxiter",
                     "dist=1", "part=1", "uv=1", "--log-every", "0",
                     "--device", "cpu", "--plots", "3", "--fem-root",
                     root]) == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["n"] for e in events if e["event"] == "plots"] == [3]
    names = sorted(os.listdir(os.path.join(out, "plots")))
    assert names == ["comparison_0000.png", "comparison_0027.png",
                     "comparison_0054.png"]
    for name in names:
        _png(os.path.join(out, "plots", name))
