"""PyTorch port: its own ctypes binding of the native point-generation
library (``geometry/native.py``), built with ``g++`` from
``native/pointgen.cpp`` into a temporary directory, held to the port's numpy
geometry as ``tests/test_native.py`` holds the JAX package's binding."""

import os

import numpy as np
import pytest

from pinn_elastodynamics_torch.geometry import distance, native
from pinn_elastodynamics_torch.geometry import sampling as smp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """Build into a fresh directory (first use), leaving ``native/`` as it
    was; the module's cached library is restored afterwards."""
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("build"))
    mp.setattr(native, "_lib", None)
    mp.setattr(native, "_load_error", None)
    assert native.available(), native.load_error()
    assert native.load_error() is None
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
    yield native
    mp.undo()


def test_build_is_reused_and_failures_are_reported(lib, monkeypatch,
                                                   tmp_path):
    path = lib.library_path()
    assert lib.build() == path and native.num_threads() >= 1
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    assert not native.available()
    assert "no-such-compiler" in native.load_error()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.lhs(2, 4, seed=0)
    assert native.num_threads() == 0 and os.listdir(tmp_path) == []


def test_native_lhs_stratification(lib):
    n = 128
    s = lib.lhs(3, n, seed=42)
    assert s.shape == (n, 3)
    for j in range(3):
        strata = np.floor(s[:, j] * n).astype(int)
        assert sorted(strata) == list(range(n))


def test_native_lhs_deterministic(lib):
    a = lib.lhs(2, 50, seed=9)
    b = lib.lhs(2, 50, seed=9)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, lib.lhs(2, 50, seed=10))


def test_native_lhs_box_bounds(lib):
    lb, ub = (-2.0, 0.0, 1.0), (3.0, 0.5, 11.0)
    pts = lib.lhs_box(lb, ub, 2000, seed=3)
    assert (pts.min(0) >= np.array(lb)).all()
    assert (pts.max(0) <= np.array(ub)).all()


def test_native_exclude_disk_matches_numpy(lib):
    pts = np.random.default_rng(0).uniform(-1, 1, (5000, 3))
    for strict in (True, False):
        ours = lib.exclude_disk(pts, xc=0.1, yc=-0.2, r=0.5, strict=strict)
        ref = smp.exclude_disk(pts, xc=0.1, yc=-0.2, r=0.5, strict=strict)
        np.testing.assert_array_equal(ours, ref)


def test_native_plate_hole_distance_parity(lib):
    xyt = np.random.default_rng(1).uniform(0, 0.5, (3000, 3))
    xyt[:, 2] *= 20
    np.testing.assert_allclose(lib.plate_hole_distance(xyt),
                               distance.plate_hole_distance(xyt), atol=1e-15)


def test_native_cross_time_parity(lib):
    rng = np.random.default_rng(2)
    xy = rng.uniform(size=(37, 2))
    t = np.linspace(0, 10, 11)
    np.testing.assert_array_equal(lib.cross_time(xy, t),
                                  smp.cross_time(xy, t))
