"""PyTorch port: every public helper of ``geometry/sampling.py``,
``geometry/sources.py`` and ``geometry/distance.py`` against its JAX
namesake, in float64, each side drawing from a fresh generator of the same
numpy seed.  The arguments are ones the cases do not pass: a second seed,
ragged counts, points on the hole's edge and on the source circle.  A helper
that only samples or copies must match bitwise; one that evaluates a formula
within 1e-12."""

import inspect
import types

import numpy as np
import pytest

from pinn_elastodynamics_torch.geometry import distance as tdistance
from pinn_elastodynamics_torch.geometry import sampling as tsampling
from pinn_elastodynamics_torch.geometry import sources as tsources
from pinn_elastodynamics_tpu.geometry import distance as jdistance
from pinn_elastodynamics_tpu.geometry import sampling as jsampling
from pinn_elastodynamics_tpu.geometry import sources as jsources

PORT = types.SimpleNamespace(smp=tsampling, src=tsources, dst=tdistance)
JAX = types.SimpleNamespace(smp=jsampling, src=jsources, dst=jdistance)
SEEDS = (7, 2**31 - 1)
RAGGED = 37
HOLE_R = 0.1      # the quarter plate's hole, at the origin
REL = 1e-12


def _rng(seed):
    return np.random.default_rng(seed)


def _on_hole_edge():
    """Points exactly on the hole's edge (sqrt(x * x) == x in binary
    floating point), beside points just inside and just outside it."""
    return np.array([[HOLE_R, 0.0], [0.0, HOLE_R],
                     [np.nextafter(HOLE_R, 0.0), 0.0],
                     [0.0, np.nextafter(HOLE_R, 1.0)]])


def _samples(draw):
    """``draw(rng)`` for each seed, followed by the generator's next number:
    both sides must also leave the stream at the same place."""
    out = []
    for seed in SEEDS:
        rng = _rng(seed)
        got = draw(rng)
        out += [*(got if isinstance(got, tuple) else (got,)), rng.uniform()]
    return out


def _lhs(m):
    return _samples(lambda rng: m.smp.lhs(3, RAGGED, rng))


def _lhs_box(m):
    return _samples(lambda rng: m.smp.lhs_box([-15, -15, 0], [15, 15, 6],
                                              RAGGED, rng))


def _exclude_disk(m):
    pts = np.concatenate([
        m.smp.lhs_box([0, 0], [0.3, 0.3], RAGGED, _rng(SEEDS[1])),
        _on_hole_edge()])
    kept = m.smp.exclude_disk(pts, xc=0, yc=0, r=HOLE_R, strict=False)
    strict = m.smp.exclude_disk(pts, xc=0, yc=0, r=HOLE_R, strict=True)
    # the two edge points are kept only when the test is not strict
    assert len(kept) - len(strict) == 2
    return [kept, strict,
            m.smp.exclude_disk(pts, xc=0.2, yc=-0.1, r=0.15, strict=True)]


def _circle_points(m):
    return [m.smp.circle_points(xc=0, yc=0, r=HOLE_R, n=RAGGED,
                                theta1=np.pi / 2),
            m.smp.circle_points(xc=0.25, yc=-0.5, r=2.0, n=RAGGED,
                                theta0=0.3)]


def _cross_time(m):
    xy = m.smp.lhs_box([0, 0], [0.5, 0.5], RAGGED, _rng(SEEDS[1]))
    return [m.smp.cross_time(xy, np.linspace(0.0, 10.0, 11)),
            m.smp.cross_time(xy[:1], np.array([2.5]))]


def _cart_grid_2d(m):
    return [m.smp.cart_grid_2d(-15, 15, -15, 15, RAGGED),
            m.smp.cart_grid_2d(0.0, 0.5, 0.0, 0.5, 2)]


def _grid_disk_complement(m):
    # a 5 x 5 grid on [-2, 2]^2 has four points on the r = 2 circle
    edge = m.smp.grid_disk_complement(-2, 2, -2, 2, 5, r=2.0)
    return [edge, m.smp.grid_disk_complement(0, 0.5, 0, 0.5, RAGGED,
                                             r=HOLE_R),
            m.smp.grid_disk_complement(0, 0.5, 0, 0.5, RAGGED)]


def _dist_grid_with_surface(m):
    common = dict(xmin=0.0, xmax=0.5, ymin=0.0, ymax=0.5, tmin=0.0,
                  tmax=10.0, xc=0.0, yc=0.0, r=HOLE_R, num=RAGGED, num_t=7)
    return [m.smp.dist_grid_with_surface(num_surf_pt=13, **common),
            m.smp.dist_grid_with_surface(num_surf_pt=5, arc="full",
                                         **common)]


def _edge_lhs(m):
    return _samples(lambda rng: m.smp.edge_lhs([0.5, 0.0, 0.0],
                                               [0.0, 0.5, 10.0], RAGGED, rng))


def _subsample(m):
    pts = m.smp.lhs_box([0, 0, 0], [1, 1, 1], RAGGED, _rng(SEEDS[0]))
    return [m.smp.subsample(pts, 3), m.smp.subsample(pts, 1),
            m.smp.subsample(pts, RAGGED + 1)]


def _shuffled(m):
    a = np.arange(2 * RAGGED, dtype=np.float64).reshape(RAGGED, 2)
    b = np.arange(5, dtype=np.float64)[:, None]
    return _samples(lambda rng: m.smp.shuffled(rng, a, b))


TIMES = np.concatenate([np.linspace(0.0, 10.0, RAGGED), [2.0, 3.0]])


def _cyclic_tension(m):
    return [m.src.cyclic_tension(TIMES),
            m.src.cyclic_tension(TIMES, period=2.5, amplitude=1.5),
            np.asarray(m.src.cyclic_tension(0.0))]


def _gaussian_pulse(m):
    return [m.src.gaussian_pulse(TIMES),
            m.src.gaussian_pulse(TIMES, t0=1.0, width=0.25, amplitude=2.0)]


def _ricker_wavelet(m):
    return [m.src.ricker_wavelet(TIMES),
            m.src.ricker_wavelet(TIMES, ts=1.5, tsh=0.75, amplitude=-2.0)]


def _radial_displacement(m):
    xy = m.smp.circle_points(xc=0.5, yc=-1.0, r=2.0, n=RAGGED)
    per_row = m.src.gaussian_pulse(TIMES[:RAGGED])[:, None]
    return [m.src.radial_displacement(xy, 0.5, xc=0.5, yc=-1.0),
            m.src.radial_displacement(xy, per_row, xc=0.5, yc=-1.0)]


def _plate_hole_distance(m):
    xyt = np.concatenate([
        m.smp.lhs_box([0, 0, 0], [0.5, 0.5, 10], RAGGED, _rng(SEEDS[1])),
        np.array([[0.0, 0.25, 1.0], [0.5, 0.0, 1.0], [0.25, 0.5, 0.0],
                  [HOLE_R, 0.0, 3.0]])])
    return [m.dst.plate_hole_distance(xyt)]


def _confined_wave_distance(m):
    xyt = np.concatenate([
        m.smp.lhs_box([-15, -15, 0], [15, 15, 6], RAGGED, _rng(SEEDS[1])),
        np.array([[2.0, 0.0, 1.0], [0.0, -2.0, 1.0], [15.0, 3.0, 2.0],
                  [-15.0, -15.0, 0.0]])])
    return [m.dst.confined_wave_distance(xyt)]


# name -> (case, bitwise)
CASES = {
    "lhs": (_lhs, True),
    "lhs_box": (_lhs_box, True),
    "exclude_disk": (_exclude_disk, True),
    "circle_points": (_circle_points, False),
    "cross_time": (_cross_time, True),
    "cart_grid_2d": (_cart_grid_2d, True),
    "grid_disk_complement": (_grid_disk_complement, True),
    "dist_grid_with_surface": (_dist_grid_with_surface, True),
    "edge_lhs": (_edge_lhs, True),
    "subsample": (_subsample, True),
    "shuffled": (_shuffled, True),
    "cyclic_tension": (_cyclic_tension, False),
    "gaussian_pulse": (_gaussian_pulse, False),
    "ricker_wavelet": (_ricker_wavelet, False),
    "radial_displacement": (_radial_displacement, False),
    "plate_hole_distance": (_plate_hole_distance, False),
    "confined_wave_distance": (_confined_wave_distance, False),
}


def _public(module):
    return {name for name, f in vars(module).items()
            if inspect.isfunction(f) and f.__module__ == module.__name__
            and not name.startswith("_")}


@pytest.mark.parametrize("name", list(CASES))
def test_geometry_helper_matches_jax(name):
    case, bitwise = CASES[name]
    # every public helper of the three modules has its case, and only those
    for side in (PORT, JAX):
        assert set(CASES) == set().union(*map(_public, vars(side).values()))
    got, want = case(PORT), case(JAX)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
        assert g.size > 0
        if bitwise:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=REL,
                                       atol=REL * max(1.0, np.abs(w).max()))
