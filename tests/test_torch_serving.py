"""PyTorch port: HTTP field serving on the CPU, the port's independence from
JAX, and its refusal to fall back to the CPU quietly."""

import json
import os
import shutil
import subprocess
import sys
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.eval.render import predict_fields as jpredict
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.eval.render import predict_fields
from pinn_elastodynamics_torch.serving import FieldEvaluator, FieldServer
from pinn_elastodynamics_torch.train.checkpoint import (
    load_checkpoint,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs/plate_v2/hybrid_best.ckpt")


@pytest.fixture(scope="module")
def host_params():
    return load_checkpoint(CKPT)["params"]


@pytest.fixture(scope="module")
def server(host_params):
    params = params_from_jax(host_params, device="cpu")
    ev = FieldEvaluator(tplate.build_model(), params, chunk=256,
                        name="plate", device="cpu").warmup()
    srv = FieldServer(ev).start()
    yield srv
    srv.stop()


def _post(server, path, payload):
    host, port = server.address
    req = urllib.request.Request(
        f"http://{host}:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(server, path):
    host, port = server.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz_and_meta(server):
    code, body = _get(server, "/healthz")
    assert code == 200 and body["status"] == "ok"
    code, meta = _get(server, "/meta")
    assert meta["ndim"] == 2 and meta["formulation"] == "second_order"
    assert meta["channels"] == ["u", "v", "s11", "s22", "s12"]
    assert meta["name"] == "plate" and meta["chunk"] == 256


def test_predict_roundtrip(server):
    pts = [[0.2, 0.1], [0.45, 0.3], [0.05, 0.4]]
    code, body = _post(server, "/predict", {
        "points": pts, "t": 6.0, "fields": ["u", "v", "s11"],
    })
    assert code == 200 and body["n"] == 3
    assert set(body["fields"]) == {"u", "v", "s11"}
    assert len(body["fields"]["u"]) == 3
    assert all(np.isfinite(body["fields"]["u"]))


def test_predict_matches_direct_and_jax(server, host_params):
    xy = np.random.default_rng(0).uniform(0.0, 0.5, (300, 2))
    code, body = _post(server, "/predict", {"points": xy.tolist(), "t": 2.5})
    assert code == 200
    direct = predict_fields(tplate.build_model(),
                            params_from_jax(host_params, device="cpu"), xy, 2.5,
                            chunk=256, device="cpu")
    jparams = {k: [{n: jnp.asarray(v, jnp.float32) for n, v in layer.items()}
                   for layer in net] for k, net in host_params.items()}
    ref = jpredict(jplate.build_model(), jparams, xy, 2.5, chunk=256)
    assert set(body["fields"]) == set(direct) == set(ref)
    for k in direct:
        np.testing.assert_array_equal(np.asarray(body["fields"][k], np.float32),
                                      direct[k])
        # Two f32 evaluations (torch and XLA sum in different orders), each
        # within the 1e-5·max(1, max|ref|) limit of an f32 forward.
        np.testing.assert_allclose(direct[k], ref[k], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref[k]).max()))


def test_predict_error_paths(server):
    code, body = _post(server, "/predict", {"points": [[1.0]], "t": 0})
    assert code == 400 and "points" in body["error"]
    code, body = _post(server, "/predict", {
        "points": [[0.0, 0.0]], "fields": ["bogus"],
    })
    assert code == 400 and "bogus" in body["error"]
    code, body = _post(server, "/predict", {"t": 1.0})
    assert code == 400 and "points" in body["error"]
    code, body = _post(server, "/nope", {})
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server, "/nope")
    assert err.value.code == 404


def test_server_stop_ends_its_thread():
    ev = FieldEvaluator(tplate.build_model(bc="analytic"),
                        {"uv": params_from_jax(
                            [{"W": np.zeros((3, 5)), "b": np.ones(5)}],
                            device="cpu")},
                        device="cpu")
    srv = FieldServer(ev).start()
    try:
        code, body = _post(srv, "/predict", {"points": [[0.3, 0.2]], "t": 1.0})
        assert code == 200 and len(body["fields"]["u"]) == 1
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


def test_evaluator_without_device_needs_gpu(monkeypatch, host_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = params_from_jax(host_params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        FieldEvaluator(tplate.build_model(), params)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import pinn_elastodynamics_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "pinn_elastodynamics_tpu")))
print(",".join(names))
print(len(names), bad)
"""
# Modules that must be among those walked (the entry points and the cases).
MUST_WALK = {f"pinn_elastodynamics_torch.{m}" for m in (
    "run", "serving", "cases.plate_hole", "cases.wave_common",
    "cases.wave_confined", "cases.wave_infinite", "cases.wave_semi_infinite",
    "train.curriculum", "train.lbfgs", "utils.logging", "cases.elastic3d",
    "train.lbfgs_host", "train.step", "entry")}


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked, last = out.stdout.strip().splitlines()[-2:]
    assert MUST_WALK <= set(walked.split(",")), walked
    count, bad = last.split(" ", 1)
    pkg = os.path.join(REPO, "pinn_elastodynamics_torch")
    n_files = 0
    for root, dirs, files in os.walk(pkg):  # packages only, not build output
        dirs[:] = [d for d in dirs
                   if os.path.exists(os.path.join(root, d, "__init__.py"))]
        n_files += sum(f.endswith(".py") for f in files)
    assert int(count) == n_files - 1 and bad == "[]", out.stdout


def test_chip_smoke_refuses_to_run_without_gpu(tmp_path):
    """No CUDA GPU here: the smoke exits non-zero and prints no result, in
    the repo and alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
