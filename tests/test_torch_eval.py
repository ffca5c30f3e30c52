"""PyTorch port: the FEM comparison (``eval/fem.py``, ``eval/metrics.py``,
``eval/compare.py``) and the CLI's ``--compare-fem`` against the JAX
package on the CPU.  The FEM frames are synthetic ``.mat`` files written
with ``scipy.io.savemat``; both packages read the same directory (the JAX
case through its ``fem_dir``, the port's through ``fem_root``)."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.cases import wave_confined as jconf
from pinn_elastodynamics_tpu.eval import compare as jcmp
from pinn_elastodynamics_tpu.eval import fem as jfem
from pinn_elastodynamics_tpu.eval import metrics as jmet
from pinn_elastodynamics_torch import run as cli
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.cases import wave_confined as tconf
from pinn_elastodynamics_torch.eval import compare as tcmp
from pinn_elastodynamics_torch.eval import fem as tfem
from pinn_elastodynamics_torch.eval import metrics as tmet
from pinn_elastodynamics_torch.train import checkpoint as tckpt

F64 = torch.float64
REL = 1e-10        # float64 parity, relative
CHUNK = 1024       # render chunk here: every frame is a few thousand points
PLATE_CKPT = "runs/plate_v2/hybrid_best.ckpt"


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
    """Both packages render in chunks of CHUNK points (the default pads
    every frame to 65,536); a frame of the plate spans two chunks."""
    from pinn_elastodynamics_tpu.eval import render as jrender
    from pinn_elastodynamics_torch.eval import render as trender

    monkeypatch.setattr(jcmp, "predict_fields", functools.partial(
        jrender.predict_fields, chunk=CHUNK))
    monkeypatch.setattr(tcmp, "predict_fields", functools.partial(
        trender.predict_fields, chunk=CHUNK))


def synthetic_fields(x, y, t):
    """Smooth displacement and stress fields, all zero at t = 0."""
    a = np.sin(0.7 * t)
    return {
        "u": 1e-3 * a * np.sin(3.0 * x + y),
        "v": 1e-3 * a * np.cos(x - 2.0 * y),
        "s11": a * (1.0 + 0.5 * x * y),
        "s22": a * np.cos(x + y),
        "s12": 0.3 * a * np.sin(x * y),
    }


def write_frames(fem_dir, frames, xy, frame_time, *, wave=False):
    """``ProbeData-<i>.mat`` with x, y (FEM coordinates) and the synthetic
    fields at t = frame_time(i); amp and Mises for a wave case."""
    os.makedirs(fem_dir, exist_ok=True)
    for i in frames:
        f = synthetic_fields(xy[:, 0], xy[:, 1], frame_time(i))
        if wave:
            f["amp"] = np.hypot(f["u"], f["v"])
            f["Mises"] = jmet.von_mises_2d(f["s11"], f["s22"], f["s12"],
                                           mu=0.25, plane="plane_strain")
        data = {"x": xy[:, :1], "y": xy[:, 1:]}
        data.update({k: v[:, None] for k, v in f.items()})
        scipy.io.savemat(os.path.join(fem_dir, f"ProbeData-{i}.mat"), data)


def plate_probes(rng, n=1500, n_ring=40):
    """Quarter-plate probe points outside the hole plus a ring on the
    r = 0.1 hole arc (what hole_edge_errors scores)."""
    xy = rng.uniform(0.0, 0.5, (3 * n, 2))
    xy = xy[np.hypot(xy[:, 0], xy[:, 1]) > 0.1][:n]
    th = np.linspace(0.0, np.pi / 2, n_ring)
    return np.concatenate([xy, 0.1 * np.stack([np.cos(th), np.sin(th)], 1)])


def _mlp(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


def _plate(root):
    """JAX and port net-BC plates reading ``root``'s frames, with the
    float64 weights of the repo's plate checkpoint."""
    host = tckpt.load_checkpoint(PLATE_CKPT)["params"]
    jcase = dataclasses.replace(jplate.build(scale=0.002),
                                fem_dir=os.path.join(root, tplate.FEM_DIR))
    tcase = tplate.build(scale=0.002, dtype=F64, device="cpu")
    return jcase, tcase, host


def _wave(root):
    """JAX and port soft confined-wave cases and seeded 3 -> 140 x 6 -> 7
    weights."""
    host = _mlp(np.random.default_rng(7), [3] + [140] * 6 + [7])
    jcase = dataclasses.replace(jconf.build(scale=0.002, jet_impl="xla"),
                                fem_dir=os.path.join(root, tconf.FEM_DIR))
    tcase = tconf.build(scale=0.002, dtype=F64, device="cpu")
    return jcase, tcase, host


CASES = {"plate": (_plate, tplate.FEM_DIR, False),
         "wave": (_wave, tconf.FEM_DIR, True)}


def _setup(tmp_path, name, frames):
    make, fem_dir, wave = CASES[name]
    root = str(tmp_path)
    jcase, tcase, host = make(root)
    rng = np.random.default_rng(11)
    if wave:   # FEM coordinates are the PINN's shifted by +15
        xy = rng.uniform(0.0, 30.0, (2500, 2))
    else:
        xy = plate_probes(rng)
    write_frames(os.path.join(root, fem_dir), frames, xy, tcase.frame_time,
                 wave=wave)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    tparams = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    return root, jcase, tcase, jparams, tparams


def _close(got, want):
    """Nested dicts and lists of floats equal within REL relative."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        assert got == pytest.approx(want, rel=REL, abs=0.0)


def test_fem_and_metrics_are_bitwise_jax(tmp_path):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0.0, 30.0, (300, 2))
    write_frames(str(tmp_path), range(4), xy, lambda i: 0.25 * i, wave=True)
    assert tfem.frame_count(str(tmp_path)) == jfem.frame_count(
        str(tmp_path)) == 4
    assert tfem.BASE_KEYS == jfem.BASE_KEYS and tfem.WAVE_KEYS == jfem.WAVE_KEYS
    for i in range(4):
        t, j = tfem.load_frame(str(tmp_path), i), jfem.load_frame(
            str(tmp_path), i)
        assert sorted(t) == sorted(j) == sorted(tfem.WAVE_KEYS)
        for k in j:
            assert t[k].dtype == np.float64 and np.array_equal(t[k], j[k])

    pred = {k: rng.standard_normal(50) for k in ("u", "v", "s11", "s22", "s12")}
    ref = {k: rng.standard_normal(50) for k in pred}
    ref["s12"] = np.zeros(50)    # skipped: reference RMS below 1e-6
    assert tmet.relative_l2(pred["u"], ref["u"]) == jmet.relative_l2(
        pred["u"], ref["u"])
    errs = tmet.field_errors(pred, ref)
    assert errs == jmet.field_errors(pred, ref) and "s12" not in errs
    frames = [errs, {"u": 0.5, "amp": 2.0}]
    assert tmet.aggregate(frames) == jmet.aggregate(frames)
    for plane in ("plane_stress", "plane_strain"):
        args = (pred["s11"], pred["s22"], pred["s12"])
        assert np.array_equal(tmet.von_mises_2d(*args, mu=0.25, plane=plane),
                              jmet.von_mises_2d(*args, mu=0.25, plane=plane))


@pytest.mark.parametrize("name", sorted(CASES))
def test_compare_frames_matches_jax(tmp_path, name):
    """Per-frame, aggregate and mid-frame errors (and one frame_errors) in
    float64 within 1e-10 relative; frame 0 is the all-zero rest state,
    whose fields are skipped."""
    probe = CASES[name][0](str(tmp_path))[1]
    mids = tcmp.mid_frames(probe)
    frames = [0, mids[0] - 3, mids[1]]
    root, jcase, tcase, jparams, tparams = _setup(
        tmp_path, name, sorted(set(frames) | set(mids)))
    assert mids == jcmp.mid_frames(jcase)
    got = tcmp.compare_frames(tcase, tparams, frames, fem_root=root)
    want = jcmp.compare_frames(jcase, jparams, frames)
    assert got["frames"] == want["frames"] == frames
    assert got["mid_frames"] == want["mid_frames"] == mids
    assert got["per_frame"][0] == want["per_frame"][0] == {}
    _close(got, want)
    want_keys = {"u", "v", "s11", "s22", "s12"}
    if CASES[name][2]:   # the wave frames carry amp and Mises
        want_keys |= {"amp", "Mises"}
    assert set(got["aggregate_mid"]) == want_keys
    _close(tcmp.frame_errors(tcase, tparams, mids[0], fem_root=root),
           jcmp.frame_errors(jcase, jparams, mids[0]))


def test_hole_edge_errors_matches_jax(tmp_path):
    """The r = 0.1 arc's stresses and hoop stress at t = 2.5, 3.75 and 5.0
    (frames 20, 30 and 40) in float64 within 1e-10 relative."""
    root, jcase, tcase, jparams, tparams = _setup(tmp_path, "plate",
                                                  [20, 30, 40])
    got = tcmp.hole_edge_errors(tcase, tparams, fem_root=root)
    want = jcmp.hole_edge_errors(jcase, jparams)
    assert [d["t"] for d in got["per_time"]] == [2.5, 3.75, 5.0]
    assert set(got["aggregate"]) == {"s11", "s22", "s12", "s_hoop"}
    _close(got, want)


def test_cli_compare_fem_writes_the_in_process_numbers(tmp_path):
    """``--compare-fem --fem-root`` on the CPU: every 5th frame plus the
    mid frames, ``fem_errors`` and ``fem_errors_mid`` events, and a
    ``fem_errors.json`` equal to an in-process ``compare_frames`` of the
    trained parameters (float32, as the CLI renders)."""
    case = tplate.build(scale=0.002, device="cpu")
    frames = list(range(0, case.n_frames, case.n_frames // 16))
    root = str(tmp_path / "ref")
    write_frames(os.path.join(root, tplate.FEM_DIR),
                 sorted(set(frames) | set(tcmp.mid_frames(case))),
                 plate_probes(np.random.default_rng(5), n=300),
                 case.frame_time)
    out = str(tmp_path / "run")
    assert cli.main(["--case", "plate_hole", "--scale", "0.002", "--out", out,
                     "--maxiter", "dist=2", "part=2", "uv=2", "--log-every",
                     "0", "--device", "cpu", "--compare-fem", "--fem-root",
                     root]) == 0
    with open(os.path.join(out, "fem_errors.json")) as f:
        written = json.load(f)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = {e["event"]: e for e in map(json.loads, f)}
    state = tckpt.load_checkpoint(os.path.join(out,
                                               "plate_hole_quarter_uv.ckpt"))
    params = tckpt.params_from_jax(state["params"], device="cpu")
    want = tcmp.compare_frames(case, params, frames, dtype=np.float32,
                               fem_root=root)
    assert written == json.loads(json.dumps(want, default=float))
    assert written["frames"] == frames and len(frames) == 17
    for event, key in (("fem_errors", "aggregate"),
                       ("fem_errors_mid", "aggregate_mid")):
        got = {k: v for k, v in events[event].items()
               if k not in ("event", "t")}
        assert got == written[key]
