"""``factor_hit_share.train`` on a set counter: the share of the closed-form
hard-BC factors' lookups that hit the model's store, and nothing (None, no
error) where the program has no such counter or looked nothing up."""

import pytest

from benchmark.core import metric_reader
from benchmark.tests.test_bench_wave_fourier import _run
from pinn_elastodynamics_torch.models import analytic_bc


@pytest.mark.parametrize("counts,share", [
    ({"hit": 398, "miss": 2, "bypass": 0}, 99.5),
    ({"hit": 0, "miss": 1, "bypass": 3}, 0.0),
    ({"hit": 0, "miss": 0, "bypass": 0}, None),         # nothing looked up
    (None, None)])                                      # a parent program
def test_factor_hit_share(monkeypatch, counts, share):
    if counts is None:
        monkeypatch.delattr(analytic_bc, "FACTOR_JETS")
    else:
        monkeypatch.setattr(analytic_bc, "FACTOR_JETS", counts)
    assert metric_reader("factor_hit_share.train")(_run()) == share
