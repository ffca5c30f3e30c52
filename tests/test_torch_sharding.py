"""PyTorch port: data parallelism over the points axis (``parallel/mesh.py``)
in gloo worlds of 2 and 4 on the CPU, f64, the counterpart of
``tests/test_sharding.py``.

Each world is spawned once for the module; its ranks rendezvous through a
``FileStore``, run every check's computation and write their results to
``tmp_path``, and each test reads them.  The references are the port's
single process and the JAX package (single device, and its own 8-device
sharded loss on the virtual CPU mesh of ``tests/conftest.py``), fed the
same seeded numpy parameters.

The ranks import this module again, so JAX is imported only inside the
parent's fixtures.
"""

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pinn_elastodynamics_torch.banks import PointBank, make_bank
from pinn_elastodynamics_torch.cases import plate_hole, wave_confined
from pinn_elastodynamics_torch.cases.base import mixed_precision_phase_fn
from pinn_elastodynamics_torch.losses import terms
from pinn_elastodynamics_torch.parallel import mesh as pmesh
from pinn_elastodynamics_torch.train import lbfgs
from pinn_elastodynamics_torch.train.adam import Adam
from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
from pinn_elastodynamics_torch.train.step import (
    make_grad_step,
    make_loss_fn,
    make_microbatched_loss_fn,
    value_and_grad,
)
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
SCALE = 0.002
WORLDS = (2, 4)
TIMEOUT_S = 60          # every process group's and every join's limit
LBFGS_ITERS = 3
MICRO = 2
CASES = {"plate": (plate_hole, {}), "wave": (wave_confined, {})}
ANALYTIC = dict(bc="analytic", fourier=8, fourier_scale=2.0)


def _mlp(rng, dims):
    return [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
             "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(dims[:-1], dims[1:])]


def _host_params(model, rng):
    """Seeded numpy parameters of ``model`` in the JAX layout."""
    if hasattr(model, "uv_net"):
        return {k: _mlp(rng, getattr(model, f"{k}_net").layers)
                for k in ("dist", "part", "uv")}
    if hasattr(model, "uv_model"):
        return {"uv": _host_params(model.uv_model, rng)}
    tree = _mlp(rng, model.layers)
    if hasattr(model, "n_features"):
        b = model.feature_scale * rng.standard_normal((3, model.n_features))
        tree = {"B": b, "mlp": tree}
    return tree


def _build(name, pad, **kw):
    mod, base = CASES[name]
    return mod.build(scale=SCALE, pad_to_multiple_of=pad, dtype=F64,
                     device="cpu", **base, **kw)


def _flat(tree):
    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)]
                     ).numpy()


def _pad_tail(bank: PointBank, extra: int) -> PointBank:
    """``bank`` with ``extra`` more padding rows at its tail."""
    pad = lambda a: torch.cat([a, a.new_zeros((extra,) + a.shape[1:])])
    return PointBank(xyt=pad(bank.xyt), mask=pad(bank.mask),
                     values={k: pad(v) for k, v in bank.values.items()})


def _uneven(banks):
    """Every bank padded at its tail by half its length again (rounded to
    8), so the last ranks hold fewer valid rows, or none."""
    return {k: _pad_tail(b, 8 * -(-b.n_total // 16)) for k, b in banks.items()}


# ---------------------------------------------------------------------------
# The computations, shared by the ranks (sharded) and the parent (single
# process, mesh=None).

def _value_and_grad(case, params, banks, fn=None):
    fn = fn or make_loss_fn(case.model, case.loss, case.material)
    (loss, comps), grads = value_and_grad(lambda p: fn(p, banks), params,
                                          has_aux=True)
    return dict(loss=float(loss), grads=_flat(grads),
                comps={k: float(v) for k, v in comps.items()})


def _lbfgs(case, params, banks):
    evals = []

    def fn(p):
        evals.append(1)
        total, _ = case.loss.evaluate(case.model, p, case.material, banks)
        return total

    res = lbfgs.minimize(fn, params, maxiter=LBFGS_ITERS,
                         segment=LBFGS_ITERS)
    return dict(loss=float(res.final_loss), evals=len(evals),
                iters=res.n_iters, params=_flat(res.params))


def _adam(case, params, banks):
    opt = Adam(1e-3)
    state = opt.init(params)
    step = make_grad_step(case.model, case.loss, case.material, opt)
    out = dict(losses=[], comps=[])
    for _ in range(2):
        params, state, loss, comps = step(params, state, banks)
        out["losses"].append(float(loss))
        out["comps"].append(sorted(comps))
    out["params"] = _flat(params)
    out["count"] = state["count"]
    return out


def _computations(shard, host):
    """The checks' numbers on banks padded to 8; ``shard(banks)`` places a
    case's banks (the identity in the single process)."""
    out = {}
    for name in CASES:
        case = _build(name, 8)
        params = params_from_jax(host[name], device="cpu", dtype=F64)
        out[name] = _value_and_grad(case, params, shard(case.banks))
    case = _build("wave", 8)
    params = params_from_jax(host["wave"], device="cpu", dtype=F64)
    out["uneven"] = _value_and_grad(case, params, shard(_uneven(case.banks)))

    case = _build("plate", 8)
    params = params_from_jax(host["plate"], device="cpu", dtype=F64)
    out["adam"] = _adam(case, params, shard(case.banks))
    out["lbfgs"] = _lbfgs(case, params, shard(case.banks))
    out["mixed"] = _mixed(shard, host)
    return out


def _mixed(shard, host):
    """The uv phase of ``mixed_precision_phase_fn``: float64 parameters and
    loss tail over float32 banks and jets."""
    case = plate_hole.build(scale=SCALE, pad_to_multiple_of=8,
                            dtype=torch.float32, device="cpu")
    case = dataclasses.replace(case, banks=shard(case.banks))
    params = params_from_jax(host["plate"], device="cpu", dtype=F64)
    fn, sub, _ = mixed_precision_phase_fn(case, case.phases[-1], params)
    loss, grads = value_and_grad(fn, sub)
    return dict(loss=float(loss), dtype=str(loss.dtype), grads=_flat(grads))


def _world_computations(shard, host, size):
    """The checks' numbers on banks padded to 2 × ``size``: the
    microbatched loss and ``dryrun_multichip``'s analytic + Fourier8
    L-BFGS segment."""
    out = {}
    case = _build("wave", MICRO * size)
    params = params_from_jax(host["wave"], device="cpu", dtype=F64)
    micro = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                      num_microbatches=MICRO)
    out["micro"] = _value_and_grad(case, params, shard(case.banks), micro)

    case = _build("plate", 2 * size, **ANALYTIC)
    params = params_from_jax(host["analytic"], device="cpu", dtype=F64)
    out["analytic"] = _lbfgs(case, params, shard(case.banks))
    return out


# ---------------------------------------------------------------------------
# One rank of a spawned world.

def _rank_results(mesh, host):
    rows = []
    add = terms.MaskedSums.add

    def counted_add(self, name, r, mask):
        rows.append((self.term, r.shape[0]))
        return add(self, name, r, mask)

    out = dict(jax_loaded="jax" in sys.modules,
               mesh=(mesh.rank, mesh.size, mesh.axis_name, str(mesh.device),
                     str(dist.get_backend(mesh.group))))
    try:
        pmesh.shard_bank(make_bank(np.zeros((2 * mesh.size + 1, 3)),
                                   device="cpu"), mesh)
    except ValueError as err:
        out["indivisible"] = str(err)

    case = _build("plate", 8)
    sharded = pmesh.shard_banks(case.banks, mesh)
    out["shards"] = {k: (b.xyt.numpy(), b.mask.numpy(),
                         {v: t.numpy() for v, t in b.values.items()},
                         b.mesh is mesh)
                     for k, b in sharded.items()}

    # One value+grad: the rows each term evaluates and the reductions.
    params = params_from_jax(host["plate"], device="cpu", dtype=F64)
    fn = make_loss_fn(case.model, case.loss, case.material)
    terms.MaskedSums.add = counted_add
    pmesh.reset_collectives()
    try:
        value_and_grad(lambda p: fn(p, sharded)[0], params)
    finally:
        terms.MaskedSums.add = add
    out["rows"] = rows
    out["term_banks"] = [b for b, _ in case.loss.terms]
    out["collectives"] = dict(pmesh.COLLECTIVES)

    wrapped = pmesh.sum_grads_over_ranks(
        {"w": torch.ones(2, dtype=F64, requires_grad=True)}, mesh)
    try:
        pmesh.sum_grads_over_ranks(wrapped, mesh)
    except ValueError as err:
        out["double_wrap"] = str(err)

    # The parameters on rank 0 reach every rank bit for bit.
    garbage = {"p": torch.full((3,), float(mesh.rank), dtype=F64),
               "count": 7 + mesh.rank}
    out["replicated"] = pmesh.replicate(garbage, mesh)

    # Uneven valid counts: the mean of the ranks' own masked means.
    case = _build("wave", 8)
    local = {k: dataclasses.replace(b, mesh=None) for k, b in
             pmesh.shard_banks(_uneven(case.banks), mesh).items()}
    params = params_from_jax(host["wave"], device="cpu", dtype=F64)
    out["local_loss"] = _value_and_grad(case, params, local)["loss"]
    out["local_valid"] = float(local["collocation"].mask.sum())

    shard = lambda b: pmesh.shard_banks(b, mesh)
    reduced = []
    all_reduce = dist.all_reduce

    def recorded(t, *args, **kwargs):
        reduced.append(str(t.dtype))
        return all_reduce(t, *args, **kwargs)

    dist.all_reduce = recorded
    try:
        _mixed(shard, host)
    finally:
        dist.all_reduce = all_reduce
    out["mixed_reduced"] = reduced

    pmesh.reset_collectives()
    out["results"] = {**_computations(shard, host),
                      **_world_computations(shard, host, mesh.size)}
    out["collectives_total"] = dict(pmesh.COLLECTIVES)
    out["jax_loaded_after"] = "jax" in sys.modules
    return out


def _rank_main(rank, size, root):
    torch.set_num_threads(1)
    with open(os.path.join(root, "host.pkl"), "rb") as f:
        host = pickle.load(f)
    store = dist.FileStore(os.path.join(root, "store"), size)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = _rank_results(pmesh.make_mesh(device="cpu"), host)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# Fixtures: spawn both worlds, compute the references meanwhile, join.

@pytest.fixture(scope="module")
def host():
    rng = np.random.default_rng(15)
    return {
        "plate": _host_params(plate_hole.build_model(), rng),
        "wave": _host_params(wave_confined.build_model(), rng),
        "analytic": _host_params(plate_hole.build_model(**ANALYTIC), rng),
    }


@pytest.fixture(scope="module")
def _spawned(host, tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for size in WORLDS:
        root = str(tmp_path_factory.mktemp(f"world{size}"))
        # The parameters go through a file: a large argument would hold
        # each start() until the rank has imported this module.
        with open(os.path.join(root, "host.pkl"), "wb") as f:
            pickle.dump(host, f)
        procs[size] = (root, [ctx.Process(target=_rank_main,
                                          args=(r, size, root))
                              for r in range(size)])
        for p in procs[size][1]:
            p.start()
    yield procs
    for _, ps in procs.values():
        for p in ps:
            if p.is_alive():
                p.terminate()
                p.join(5)


@pytest.fixture(scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single(_spawned, _one_thread, host):
    """The port's single process, per world's padding; ``full`` is the
    full-batch loss of the microbatched one's banks."""
    base = _computations(lambda b: b, host)
    out = {}
    for size in WORLDS:
        case = _build("wave", MICRO * size)
        params = params_from_jax(host["wave"], device="cpu", dtype=F64)
        out[size] = {**base, **_world_computations(lambda b: b, host, size),
                     "full": _value_and_grad(case, params, case.banks)}
    return out


@pytest.fixture(scope="module")
def jax_refs(_spawned, host):
    """JAX: single-device loss and gradients, and the 8-device sharded loss
    (the virtual CPU mesh), on the same banks (padded to 8)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from pinn_elastodynamics_tpu.cases import plate_hole as jplate
    from pinn_elastodynamics_tpu.cases import wave_confined as jconf
    from pinn_elastodynamics_tpu.parallel import mesh as jmesh
    from pinn_elastodynamics_tpu.train.step import make_loss_fn as jloss_fn

    mesh8 = jmesh.make_mesh(jax.devices())
    out = {}
    for name, mod in (("plate", jplate), ("wave", jconf)):
        case = mod.build(scale=SCALE, pad_to_multiple_of=8, dtype=np.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              host[name])
        loss_fn = jloss_fn(case.model, case.loss, case.material)
        scalar = lambda p, b: loss_fn(p, b)[0]
        loss, grads = jax.jit(jax.value_and_grad(scalar))(params, case.banks)
        sharded = jax.jit(scalar)(jmesh.replicate(params, mesh8),
                                  jmesh.shard_banks(case.banks, mesh8))
        out[name] = dict(loss=float(loss),
                         grads=np.asarray(ravel_pytree(grads)[0]),
                         mesh8=float(sharded))
    return out


@pytest.fixture(scope="module")
def worlds(_spawned, single, jax_refs):
    """size -> the ranks' results, once every rank exited 0."""
    out = {}
    for size, (root, procs) in _spawned.items():
        for p in procs:
            p.join(TIMEOUT_S)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * size, f"world {size}: exit codes {codes}"
        ranks = []
        for r in range(size):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        out[size] = ranks
    return out


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        np.testing.assert_array_equal(get(r), first)
    return first


# ---------------------------------------------------------------------------
# Tests.

def test_mesh_construction_without_group():
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.axis_name == pmesh.POINTS_AXIS == "points"
    assert mesh.device == torch.device("cpu")
    if not torch.cuda.is_available():   # the default is the card, never
        with pytest.raises(RuntimeError, match="no CUDA GPU"):   # the CPU
            pmesh.make_mesh()


@pytest.mark.parametrize("size", WORLDS)
def test_mesh_construction(worlds, size):
    ranks = worlds[size]
    assert [r["mesh"] for r in ranks] == [
        (i, size, "points", "cpu", "gloo") for i in range(size)]
    assert not any(r["jax_loaded"] or r["jax_loaded_after"] for r in ranks)


@pytest.mark.parametrize("size", WORLDS)
def test_indivisible_bank_rejected(worlds, size):
    for r in worlds[size]:
        assert "not divisible" in r["indivisible"]
        assert "pad_to_multiple_of" in r["indivisible"]


@pytest.mark.parametrize("size", WORLDS)
def test_shards_concatenate_to_the_bank(worlds, size):
    banks = _build("plate", 8).banks
    for k, bank in banks.items():
        parts = [r["shards"][k] for r in worlds[size]]
        assert all(p[3] for p in parts)          # marked with their mesh
        assert {p[0].shape[0] for p in parts} == {bank.n_total // size}
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                      bank.xyt.numpy())
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                      bank.mask.numpy())
        for v, t in bank.values.items():
            np.testing.assert_array_equal(
                np.concatenate([p[2][v] for p in parts]), t.numpy())


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_equals_single_process(worlds, single, name, size):
    ref = single[size][name]
    loss = _same_on_every_rank(worlds[size],
                               lambda r: r["results"][name]["loss"])
    assert loss == pytest.approx(ref["loss"], rel=1e-12)
    comps = worlds[size][0]["results"][name]["comps"]
    assert comps.keys() == ref["comps"].keys()
    for k, v in ref["comps"].items():
        assert comps[k] == pytest.approx(v, rel=1e-12), k


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_grads_equal_single_process(worlds, single, name, size):
    grads = _same_on_every_rank(worlds[size],
                                lambda r: r["results"][name]["grads"])
    np.testing.assert_allclose(grads, single[size][name]["grads"],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_jax(worlds, jax_refs, name, size):
    """Against JAX's single device (loss and gradients) and JAX's own
    8-device sharded loss."""
    ref = jax_refs[name]
    got = worlds[size][0]["results"][name]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-10)
    assert got["loss"] == pytest.approx(ref["mesh8"], rel=1e-10)
    scale = max(1.0, float(np.abs(ref["grads"]).max()))
    assert float(np.abs(got["grads"] - ref["grads"]).max()) <= 1e-10 * scale


@pytest.mark.parametrize("size", WORLDS)
def test_uneven_valid_counts_give_global_means(worlds, single, size):
    """The last ranks hold fewer valid rows (or none): the loss is still the
    global masked mean, which a mean of the ranks' means is not."""
    ranks = worlds[size]
    valid = [r["local_valid"] for r in ranks]
    assert valid[-1] < valid[0]
    ref = single[size]["uneven"]
    loss = _same_on_every_rank(ranks, lambda r: r["results"]["uneven"]["loss"])
    assert loss == pytest.approx(ref["loss"], rel=1e-12)
    grads = _same_on_every_rank(ranks,
                                lambda r: r["results"]["uneven"]["grads"])
    np.testing.assert_allclose(grads, ref["grads"], rtol=1e-10, atol=1e-12)
    # Padding is loss-neutral: the same loss as the evenly padded banks.
    assert loss == pytest.approx(single[size]["wave"]["loss"], rel=1e-12)
    mean_of_means = float(np.mean([r["local_loss"] for r in ranks]))
    assert abs(mean_of_means - loss) > 1e-3 * loss


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_adam_steps(worlds, single, size):
    ranks = worlds[size]
    ref = single[size]["adam"]
    for r in ranks:
        got = r["results"]["adam"]
        assert all(np.isfinite(got["losses"]))
        assert got["comps"] == [["HOLE", "f_s", "f_uv"]] * 2
        assert got["count"] == 2
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-12)
    params = _same_on_every_rank(ranks,
                                 lambda r: r["results"]["adam"]["params"])
    scale = max(1.0, float(np.abs(ref["params"]).max()))
    assert float(np.abs(params - ref["params"]).max()) <= 1e-10 * scale


@pytest.mark.parametrize("size", WORLDS)
def test_replicate_broadcasts_rank0(worlds, size):
    for r in worlds[size]:
        rep = r["replicated"]
        assert rep["count"] == 7
        np.testing.assert_array_equal(rep["p"].numpy(), np.zeros(3))


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("key", ["lbfgs", "analytic"])
def test_sharded_lbfgs(worlds, single, key, size):
    """3 L-BFGS iterations of the net-BC plate and of the analytic +
    Fourier8 plate (``dryrun_multichip``'s segments): the single process's
    final loss and evaluation count, every rank bit for bit the same."""
    ranks = worlds[size]
    ref = single[size][key]
    params = _same_on_every_rank(ranks, lambda r: r["results"][key]["params"])
    evals = _same_on_every_rank(ranks, lambda r: r["results"][key]["evals"])
    loss = _same_on_every_rank(ranks, lambda r: r["results"][key]["loss"])
    assert ranks[0]["results"][key]["iters"] == LBFGS_ITERS
    assert evals == ref["evals"]
    assert loss == pytest.approx(ref["loss"], rel=1e-8)
    assert np.isfinite(params).all()


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_microbatched_matches_full(worlds, single, size):
    """2 microbatches of each rank's shard against the full batch."""
    ref = single[size]["full"]
    got = worlds[size][0]["results"]["micro"]
    _same_on_every_rank(worlds[size], lambda r: r["results"]["micro"]["grads"])
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-10)
    for k, v in ref["comps"].items():
        assert got["comps"][k] == pytest.approx(v, rel=1e-9), k
    np.testing.assert_allclose(got["grads"], ref["grads"], rtol=1e-8,
                               atol=1e-12)
    # The single process's microbatched loss agrees too.
    assert single[size]["micro"]["loss"] == pytest.approx(ref["loss"],
                                                          rel=1e-10)


@pytest.mark.parametrize("size", WORLDS)
def test_each_rank_evaluates_its_rows_and_reduces_once(worlds, size):
    """The counterpart of the JAX no-all-gather test: each term sees n/size
    rows; one reduction of the sums and one of the gradients per
    value+grad."""
    banks = _build("plate", 8).banks
    for r in worlds[size]:
        assert r["collectives"] == {"sums": 1, "grads": 1}
        assert r["rows"]
        for term, rows in r["rows"]:
            assert rows == banks[r["term_banks"][term]].n_total // size
        assert "twice" in r["double_wrap"]
        # The rest: 3 value+grads, 2 Adam steps, the L-BFGS evaluations,
        # the mixed-precision and the microbatched value+grad.
        res = r["results"]
        n_vg = 3 + 2 + res["lbfgs"]["evals"] + 1 + 1 + res["analytic"]["evals"]
        assert r["collectives_total"] == {"sums": n_vg, "grads": n_vg}


@pytest.mark.parametrize("size", WORLDS)
def test_mixed_precision_reduces_in_float64(worlds, single, size):
    """``mixed_precision_phase_fn`` (float32 banks and jets, float64
    parameters and ``accum_dtype``): its sums and counts are reduced in
    float64 (the gradient of the float32 leaves the model sees in
    float32), and it agrees with the single process to float32's
    resolution."""
    ranks = worlds[size]
    ref = single[size]["mixed"]
    got = ranks[0]["results"]["mixed"]
    assert got["dtype"] == "torch.float64"
    for r in ranks:
        assert r["mixed_reduced"] == ["torch.float64", "torch.float32"]
    _same_on_every_rank(ranks, lambda r: r["results"]["mixed"]["grads"])
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    scale = max(1.0, float(np.abs(ref["grads"]).max()))
    assert float(np.abs(got["grads"] - ref["grads"]).max()) <= 1e-5 * scale


def test_unsharded_and_sharded_banks_do_not_mix():
    mesh = pmesh.make_mesh(device="cpu")
    case = _build("plate", 8)
    banks = dict(case.banks)
    banks["collocation"] = pmesh.shard_bank(banks["collocation"], mesh)
    fn = make_loss_fn(case.model, case.loss, case.material)
    params = case.init_params(0, F64)
    with pytest.raises(ValueError, match="different meshes"):
        fn(params, banks)


def test_mesh_of_one_rank_is_the_identity(host, _one_thread):
    """With no process group the sharded path reduces nothing and gives the
    unsharded loss and gradients bit for bit."""
    mesh = pmesh.make_mesh(device="cpu")
    case = _build("plate", 8)
    params = params_from_jax(host["plate"], device="cpu", dtype=F64)
    pmesh.reset_collectives()
    got = _value_and_grad(case, params, pmesh.shard_banks(case.banks, mesh))
    assert pmesh.COLLECTIVES == {"sums": 0, "grads": 0}
    ref = _value_and_grad(case, params, case.banks)
    assert got["loss"] == ref["loss"] and got["comps"] == ref["comps"]
    np.testing.assert_array_equal(got["grads"], ref["grads"])
