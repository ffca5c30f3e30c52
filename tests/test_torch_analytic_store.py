"""PyTorch port: the hard-BC composite's store of its closed-form factors
(``models/analytic_bc.py``): D's and P's jets and values kept per points
tensor and read back while the tensor is unchanged.

On the CPU, at W2's (the confined wave with hard BCs and 64 Fourier
features) small size, in float32 and float64:

- value+grads of the phase loss with the store give the loss and every
  gradient leaf bitwise as a model whose store is cleared before each
  call, and ``FACTOR_JETS`` counts two misses, then only hits;
- an in-place change to the points recomputes, a new tensor of equal
  values misses, and points that require grad, calls under ``torch.func``
  and calls in inference mode store nothing; every answer is the bits of
  a fresh model on fresh points;
- the store lets go of the points it was filled for, and a copied or
  pickled model starts with an empty one;
- a loss evaluated in inference mode leaves the bank's next value+grad
  the uncached one;
- threads sharing a model's store lose no count and read back the same
  bits.
"""

import copy
import dataclasses
import gc
import pickle
import sys
import threading

import pytest
import torch

from pinn_elastodynamics_torch.cases import wave_confined
from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
from pinn_elastodynamics_torch.models import analytic_bc
from pinn_elastodynamics_torch.models.analytic_bc import FACTOR_JETS
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils.tree import tree_leaves, tree_map

DTYPES = [torch.float32, torch.float64]


def _case(dtype):
    case = wave_confined.build(scale=1e-3, bc="hard", fourier=64,
                               dtype=dtype, device="cpu")
    params = case.model.init(torch.Generator().manual_seed(3), dtype, "cpu")
    phase = dataclasses.replace(case.phases[-1], trainable="uv.mlp")
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    return case, params, sub_fn, sub0


def _iterate(sub0, k):
    """The k-th of a few nearby iterates, as a line search visits them."""
    return tree_map(lambda t: t * (1.0 + 0.01 * k), sub0)


def _assert_bitwise(got, want):
    (loss, grads), (loss0, grads0) = got, want
    assert torch.equal(loss, loss0)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads0), strict=True):
        assert torch.equal(a, b)


def _counts(hit=0, miss=0, bypass=0):
    return {"hit": hit, "miss": miss, "bypass": bypass}


@pytest.fixture(autouse=True)
def fresh_counts():
    analytic_bc.reset_factor_jets()


@pytest.mark.parametrize("dtype", DTYPES)
def test_stored_factors_give_the_uncached_value_and_grad(dtype):
    case, _, sub_fn, sub0 = _case(dtype)
    store = case.model._store
    cached = []
    for k in range(3):
        cached.append(value_and_grad(sub_fn, _iterate(sub0, k)))
        # the collocation rows' jet and the source rows' values
        assert FACTOR_JETS == _counts(hit=2 * k, miss=2)
    assert len(store.entries) == 2
    for k in range(3):
        store.clear()
        _assert_bitwise(cached[k], value_and_grad(sub_fn, _iterate(sub0, k)))


def _points(dtype, n=24, seed=5):
    gen = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-15.0, -15.0, 0.0], dtype=dtype)
    return lo + torch.rand(n, 3, generator=gen, dtype=dtype) * torch.tensor(
        [30.0, 30.0, 14.0], dtype=dtype)


def _call(model, params, x, kind):
    if kind == "jet":
        out = model.jet(params, x)
        return torch.cat([out.f[None], out.d])
    return model.apply(params, x)


def _plain(kind, params, x):
    """The answer of a model with an empty store on a fresh copy of x."""
    return _call(wave_confined.build_model(bc="hard", fourier=64), params,
                 x.detach().clone(), kind)


# scenario -> (first call's points from x, second call's, counts, entries
# left in the store)
SCENARIOS = {
    "same_tensor": (lambda x: x, lambda x: x, _counts(hit=1, miss=1), 1),
    "in_place_change": (lambda x: x, lambda x: x.mul_(0.5).add_(0.25),
                        _counts(miss=2), 1),
    "equal_values": (lambda x: x, lambda x: x.clone(), _counts(miss=2), 2),
    "requires_grad": (lambda x: x.requires_grad_(), lambda x: x,
                      _counts(bypass=2), 0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["jet", "apply"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_lookups_hit_only_unchanged_points(dtype, kind, scenario):
    first, second, counts, entries = SCENARIOS[scenario]
    model = wave_confined.build_model(bc="hard", fourier=64)
    params = model.init(torch.Generator().manual_seed(9), dtype, "cpu")
    x = _points(dtype)
    kept = [first(x)]
    _call(model, params, kept[0], kind)
    kept.append(second(kept[0]))
    got = _call(model, params, kept[1], kind)
    assert FACTOR_JETS == counts
    assert len(model._store.entries) == entries
    assert torch.equal(got, _plain(kind, params, kept[1]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["jet", "apply"])
@pytest.mark.parametrize("how", ["grad_of_points", "grad_of_params",
                                 "inference_mode", "inference_points"])
def test_transforms_and_inference_mode_store_nothing(dtype, kind, how):
    model = wave_confined.build_model(bc="hard", fourier=64)
    params = model.init(torch.Generator().manual_seed(9), dtype, "cpu")
    x = _points(dtype)
    want = _plain(kind, params, x)
    analytic_bc.reset_factor_jets()
    if how == "grad_of_points":       # the points are wrapped
        torch.func.grad(lambda p: _call(model, params, p, kind).sum())(x)
    elif how == "grad_of_params":     # plain points under the transform
        torch.func.grad(lambda uv: _call(model, {"uv": uv}, x, kind).sum())(
            params["uv"])
    elif how == "inference_mode":
        with torch.inference_mode():
            assert torch.equal(_call(model, params, x, kind), want)
    else:                             # points made in inference mode
        with torch.inference_mode():
            made = x.clone()
        assert torch.equal(_call(model, params, made, kind), want)
    assert FACTOR_JETS == _counts(bypass=1)
    assert len(model._store.entries) == 0
    # the plain call after it fills the store as on a fresh model
    analytic_bc.reset_factor_jets()
    assert torch.equal(_call(model, params, x, kind), want)
    assert FACTOR_JETS == _counts(miss=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_store_lets_go_of_dead_points(dtype):
    model = wave_confined.build_model(bc="hard", fourier=64)
    params = model.init(torch.Generator().manual_seed(9), dtype, "cpu")
    x = _points(dtype)
    with torch.no_grad():
        model.jet(params, x)
        model.apply(params, x)
    assert len(model._store.entries) == 1
    assert len(model._store.entries[x]) == 2        # ("jet", 1), ("apply", 0)
    del x
    gc.collect()
    assert len(model._store.entries) == 0


def test_a_copied_or_pickled_model_starts_with_an_empty_store():
    model = wave_confined.build_model(bc="hard", fourier=64)
    params = model.init(torch.Generator().manual_seed(9), torch.float32,
                        "cpu")
    x = _points(torch.float32)
    model.apply(params, x)
    for other in (pickle.loads(pickle.dumps(model)), copy.deepcopy(model)):
        assert other == model and hash(other) == hash(model)
        assert len(other._store.entries) == 0
    assert len(model._store.entries) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_inference_mode_leaves_training_uncached(dtype):
    case, _, sub_fn, sub0 = _case(dtype)
    with torch.inference_mode():
        sub_fn(sub0)
    assert FACTOR_JETS == _counts(bypass=2)
    assert len(case.model._store.entries) == 0
    got = value_and_grad(sub_fn, sub0)
    assert FACTOR_JETS == _counts(miss=2, bypass=2)
    case.model._store.clear()
    _assert_bitwise(got, value_and_grad(sub_fn, sub0))


def test_threads_lose_no_count_and_read_back_the_same_bits():
    """Threads looking up one model's store at once (as request threads
    serving one model do): every lookup is counted once, and every answer
    is the bits of a fresh model's."""
    model = wave_confined.build_model(bc="hard", fourier=64)
    params = model.init(torch.Generator().manual_seed(9), torch.float32,
                        "cpu")
    shared = _points(torch.float32, n=8)
    want = _plain("apply", params, shared)
    n_threads, calls = 12, 20
    bad = []

    def work(k):
        own = _points(torch.float32, n=8, seed=100 + k)
        own_want = _plain("apply", params, own)
        for _ in range(calls):
            for x, w in ((shared, want), (own, own_want)):
                if not torch.equal(_call(model, params, x, "apply"), w):
                    bad.append(k)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not bad
    # each thread's fresh model missed once more; the store's own lookups
    # are 2 a call
    assert sum(FACTOR_JETS.values()) == n_threads * (2 * calls + 1) + 1
    assert FACTOR_JETS["bypass"] == 0
    # the threads' own points died with them
    assert len(model._store.entries) == 1
