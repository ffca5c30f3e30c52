"""PyTorch port: the collectives of ``parallel/mesh.py`` as a world of
ranks sees them, in gloo worlds of 2 and 4 on the CPU.

- Each all-reduce and all-gather opens a ``mesh.all_reduce`` (its ``kind``
  and ``bytes``) or ``mesh.all_gather`` span while a profiler records, and
  none without one; ``COLLECTIVE_BYTES`` counts the bytes of every
  collective by kind, always, and ``reset_collectives`` clears it.
- After a value+grad over sharded banks every rank holds the same loss and
  gradient, bit for bit: the ranks' line searches must branch alike.
- The sharded W1 loss of the million-point cell (M1) and its gradient, in
  float64 on the eager path, equal the benchmark's plain reference
  (``benchmark/reference/wave_confined_m1.py``) on the unsharded banks; a
  rank whose collectives are dropped does not.

Each world is spawned once for the module by ``parallel/launch.py::
run_world``; the ranks import this module again, which imports neither
JAX nor the JAX package.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import weights as wt
from benchmark.reference import wave_confined_m1 as ref_m1
from pinn_elastodynamics_torch.cases import wave_confined
from pinn_elastodynamics_torch.parallel import launch
from pinn_elastodynamics_torch.parallel import mesh as pmesh
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils import profiling
from pinn_elastodynamics_torch.utils.tree import flat_numpy

WORLDS = (2, 4)
TIMEOUT_S = 300        # each world's limit, spawn to exit
SCALE = 0.002
PAD = 64               # M1's padding: every shard a whole number of tiles
NETS = {"net": [3] + [140] * 6 + [7]}
SEED = 2**31 + 23
# Float64 with the same operations on every row: the sharded sums add the
# rows in another order than the reference's blocks and the jets multiply
# in another order, a few units of 2^-53 per addition over a few hundred
# rows (the gradient read 5e-16, the loss 0), so 1e-12 leaves three orders
# of magnitude of room.  A rank that sums its own shard alone is off by 4
# to 20 percent.
REL_TOL = 1e-12


def _case(dtype):
    return wave_confined.build(scale=SCALE, pad_to_multiple_of=PAD,
                               dtype=dtype, device="cpu", jet_impl="eager")


def _params(dtype, mesh):
    net = wt.make(NETS, SEED, torch.device("cpu"), dtype=dtype)["net"]
    return pmesh.replicate(wt.program_tree(net), mesh)


def _value_grad(case, params, banks):
    def fn(p):
        total, _ = case.loss.evaluate(case.model, p, case.material, banks)
        return total

    loss, grads = value_and_grad(fn, params)
    return loss, grads


def _mesh_spans(start: int) -> list:
    return [(s.name, dict(s.counts)) for s in profiling.spans()[start:]
            if s.name.startswith("mesh.")]


def _traced(case, params, shards, mesh) -> dict:
    """The mesh's spans of one value+grad and one all-gather, without a
    profiler and under one."""
    rows = shards["collocation"].xyt[:, :1].contiguous()
    start = len(profiling.spans())
    _value_grad(case, params, shards)
    pmesh.gather_over_ranks(rows, mesh)
    untraced = _mesh_spans(start)
    with profile(activities=[ProfilerActivity.CPU]):
        start = len(profiling.spans())
        _value_grad(case, params, shards)
        pmesh.gather_over_ranks(rows, mesh)
        traced = _mesh_spans(start)
    return {"untraced": untraced, "traced": traced,
            "gather_bytes": rows.numel() * rows.element_size()}


def _leaves(params):
    return [t for layer in params for t in (layer["W"], layer["b"])]


def _counted(case, params, shards) -> dict:
    """``COLLECTIVE_BYTES`` after one value+grad, and after a reset."""
    sums = case.loss.masked_sums(case.model, params, case.material, shards)
    pmesh.reset_collectives()
    _value_grad(case, params, shards)
    out = {"bytes": dict(pmesh.COLLECTIVE_BYTES),
           "calls": dict(pmesh.COLLECTIVES),
           "n_params": sum(t.numel() for t in _leaves(params)),
           "n_packed": sums.packed().numel()}
    pmesh.reset_collectives()
    out["after_reset"] = dict(pmesh.COLLECTIVE_BYTES)
    return out


def _rank_results(mesh, _payload) -> dict:
    out = {}
    case = _case(torch.float64)
    params = _params(torch.float64, mesh)
    shards = pmesh.shard_banks(case.banks, mesh)
    loss, grads = _value_grad(case, params, shards)
    out["loss"], out["grads"] = float(loss), flat_numpy(grads)
    dropped = {k: dataclasses.replace(b, mesh=None) for k, b in shards.items()}
    loss, grads = _value_grad(case, params, dropped)
    out["dropped_loss"], out["dropped_grads"] = float(loss), flat_numpy(grads)
    out["spans"] = _traced(case, params, shards, mesh)
    case32 = _case(torch.float32)
    out["counted"] = _counted(case32, _params(torch.float32, mesh),
                              pmesh.shard_banks(case32.banks, mesh))
    return out


@pytest.fixture(scope="module")
def worlds():
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        jobs = {size: pool.submit(launch.run_world, _rank_results, size,
                                  device="cpu", timeout_s=TIMEOUT_S)
                for size in WORLDS}
        return {size: job.result() for size, job in jobs.items()}


@pytest.fixture(scope="module")
def reference():
    """The plain reference's loss and gradient on the whole banks (real
    rows only), at the same seeded weights."""
    case = _case(torch.float64)
    banks = {}
    for name, bank in case.banks.items():
        real = bank.mask.numpy() == 1.0
        banks[name] = {"xyt": bank.xyt.numpy()[real]}
        banks[name].update({k: v.numpy()[real]
                            for k, v in bank.values.items()})
    net = wt.make(NETS, SEED, torch.device("cpu"), dtype=torch.float64)["net"]
    leaves = [t.clone().requires_grad_(True) for layer in net for t in layer]
    pairs = list(zip(leaves[0::2], leaves[1::2]))
    loss = ref_m1.loss({"net": pairs}, banks, "float64", "cpu")
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            torch.cat([g.reshape(-1) for g in grads]).numpy())


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.subtract(a, b)) / np.linalg.norm(b))


@pytest.mark.parametrize("size", WORLDS)
def test_collective_spans_under_a_profiler(worlds, size):
    for out in worlds[size]:
        counted, spans = out["counted"], out["spans"]
        n_packed, n_params = counted["n_packed"], counted["n_params"]
        assert spans["traced"] == [
            ("mesh.all_reduce", {"kind": "sums", "bytes": 8 * n_packed}),
            ("mesh.all_reduce", {"kind": "grads", "bytes": 8 * n_params}),
            ("mesh.all_gather", {"bytes": spans["gather_bytes"]}),
        ]


@pytest.mark.parametrize("size", WORLDS)
def test_no_collective_spans_without_a_profiler(worlds, size):
    for out in worlds[size]:
        assert out["spans"]["untraced"] == []


@pytest.mark.parametrize("size", WORLDS)
def test_collective_bytes_per_value_and_grad(worlds, size):
    for out in worlds[size]:
        c = out["counted"]
        assert c["n_params"] == 100247
        assert c["calls"] == {"sums": 1, "grads": 1, "gathers": 0}
        assert c["bytes"] == {"sums": 4 * c["n_packed"],
                              "grads": 4 * c["n_params"], "gathers": 0}
        assert sum(c["bytes"].values()) == 4 * (c["n_params"] + c["n_packed"])


@pytest.mark.parametrize("size", WORLDS)
def test_reset_clears_collective_bytes(worlds, size):
    for out in worlds[size]:
        assert out["counted"]["after_reset"] == {"sums": 0, "grads": 0,
                                                 "gathers": 0}


@pytest.mark.parametrize("size", WORLDS)
def test_every_rank_holds_the_same_loss_and_gradient(worlds, size):
    ranks = worlds[size]
    for out in ranks[1:]:
        assert out["loss"] == ranks[0]["loss"]
        np.testing.assert_array_equal(out["grads"], ranks[0]["grads"])


@pytest.mark.parametrize("what", ["loss", "grads"])
def test_sharded_m1_loss_equals_the_unsharded_reference(worlds, reference,
                                                        what):
    want = reference[0] if what == "loss" else reference[1]
    for out in worlds[4]:
        assert _rel(out[what], want) <= REL_TOL


def test_dropped_allreduce_fails_the_reference_comparison(worlds, reference):
    for out in worlds[4]:
        assert _rel(out["dropped_loss"], reference[0]) > 1e3 * REL_TOL
        assert _rel(out["dropped_grads"], reference[1]) > 1e3 * REL_TOL
