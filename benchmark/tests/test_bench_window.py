"""The pieces of the training check that follow the window's last update:
the program's last iterates read back from its optimizer state, the
reference's two-loop over a full memory, and the gap of vectors by leaf."""

import numpy as np
import pytest
import torch

from benchmark.drivers.train import _last_iterates
from benchmark.reference import compare
from benchmark.reference import lbfgs as ref_lbfgs


def _quartic(tree):
    w = tree[0]["W"]
    return ((w - 0.3) ** 4).sum() + (w ** 2).sum() + (tree[0]["b"] ** 2).sum()


@pytest.mark.parametrize("memory,steps", [(3, 2), (3, 9), (4, 4), (5, 11)])
def test_last_iterates_read_back_the_points_the_memory_spans(memory, steps):
    from pinn_elastodynamics_torch.train.lbfgs import minimize

    gen = torch.Generator().manual_seed(memory * 100 + steps)
    tree = [{"W": torch.randn(3, 2, generator=gen, dtype=torch.float64),
             "b": torch.randn(2, generator=gen, dtype=torch.float64)}]
    def flat(c):
        return torch.cat([c[0][0]["W"].reshape(-1), c[0][0]["b"]])

    carry = minimize(_quartic, tree, maxiter=0, memory_size=memory).carry
    points = [flat(carry)]
    for _ in range(steps):
        carry = minimize(_quartic, carry[0], maxiter=1, memory_size=memory,
                         init_carry=carry).carry
        points.append(flat(carry))
    last = _last_iterates(carry)
    # x_0 .. x_K; the state spans x_{K-1-n} .. x_{K-1}, n = min(K - 1, m)
    n = min(steps - 1, memory)
    want = [p.numpy() for p in points[steps - 1 - n:steps]]
    assert len(last["xs"]) == n + 1
    for got, ref in zip(last["xs"], want):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(last["x"], points[-1].numpy())


def test_last_direction_is_the_runs_direction_at_its_newest_point():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=7) for _ in range(5)]
    gs = [x * (1 + 0.1 * k) + rng.normal(size=7) * 0.01
          for k, x in enumerate(xs)]
    np.testing.assert_allclose(ref_lbfgs.last_direction(xs, gs),
                               ref_lbfgs.directions(xs, gs)[-1], rtol=1e-12)


def test_vector_gap_sees_a_transposed_or_flipped_leaf():
    rng = np.random.default_rng(4)
    w, b = rng.normal(size=(6, 6)), rng.normal(size=6)
    ref = np.concatenate([w.ravel(), b])
    slices = [slice(0, 36), slice(36, 42)]
    for prog in (np.concatenate([w.T.ravel(), b]),
                 np.concatenate([w.ravel(), -b])):
        assert compare.leaf_gap(prog, ref, slices) < 1e-12
        assert compare.leaf_vec_gap(prog, ref, slices) > 0.5
    assert compare.leaf_vec_gap(ref, ref, slices) == 0.0
