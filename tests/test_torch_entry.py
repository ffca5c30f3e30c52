"""PyTorch port: the framework's entry points (``entry.py``) and the
launcher of a world of ranks (``parallel/launch.py``), on the CPU.

``entry`` is held to the JAX package's ``entry`` forward at JAX's own
parameters.  ``dryrun_multichip`` runs in gloo worlds of 2 and 4 (spawned
together, as threads of the parent wait on them) at JAX's
``init_params(seed=0)``, and is held to the same pieces run by the JAX
package on one device, at the same parameters and banks, meanwhile.  The
ranks import only the port; JAX is imported in the parent's fixtures.
"""

import concurrent.futures
import math
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pinn_elastodynamics_torch import entry as tentry
from pinn_elastodynamics_torch.parallel import launch
from pinn_elastodynamics_torch.train.checkpoint import params_from_jax

WORLDS = (2, 4)
REL = 1e-5         # losses and gradient norms, f32 on both sides
LBFGS_REL = 1e-3   # 3 iterations of an f32 line search
# The JAX pieces run once, at the larger world's padding; padding is
# loss-neutral (masked means).
JAX_PAD = 2 * max(WORLDS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_trees():
    """JAX ``init_params(seed=0)`` of the dry run's two models, as numpy."""
    import jax
    import jax.numpy as jnp

    from pinn_elastodynamics_tpu.cases import plate_hole as jplate

    key = jax.random.PRNGKey(0)
    return {
        "net_bc": _jax_numpy(jplate.build_model().init(key, jnp.float32)),
        "analytic": _jax_numpy(jplate.build_model(**tentry.ANALYTIC).init(
            key, jnp.float32)),
    }


def _jax_pieces(pad):
    """The JAX dry run's pieces (the repo root's entry module), on one
    device without the mesh."""
    import jax
    import optax

    from pinn_elastodynamics_tpu.cases import plate_hole as jplate
    from pinn_elastodynamics_tpu.train.lbfgs import minimize
    from pinn_elastodynamics_tpu.train.step import (
        make_grad_step,
        make_microbatched_loss_fn,
    )

    def loss_of(case):
        return lambda p: case.loss.evaluate(case.model, p, case.material,
                                            case.banks)[0]

    out = {}
    case = jplate.build(scale=tentry.SCALE, pad_to_multiple_of=pad)
    params = case.init_params(seed=0)
    opt = optax.adam(tentry.ADAM_LR)
    step = make_grad_step(case.model, case.loss, case.material, opt)
    params, _, loss, comps = step(params, opt.init(params), case.banks)
    out["adam_loss"] = float(loss)
    out["components"] = {k: float(v) for k, v in comps.items()}
    out["lbfgs_loss"] = float(minimize(loss_of(case), params, maxiter=3,
                                       segment=3).final_loss)
    micro = make_microbatched_loss_fn(case.model, case.loss, case.material,
                                      num_microbatches=tentry.MICROBATCHES)
    (mval, _), mgrads = jax.jit(jax.value_and_grad(micro, has_aux=True))(
        params, case.banks)
    out["micro_loss"] = float(mval)
    out["micro_grad_norm"] = float(optax.global_norm(mgrads))
    case_p = jplate.build(scale=tentry.SCALE, pad_to_multiple_of=pad,
                          jet_impl="pallas")
    pval, pgrads = jax.jit(jax.value_and_grad(loss_of(case_p)))(params)
    out["kernel_loss"] = float(pval)
    out["kernel_grad_norm"] = float(optax.global_norm(pgrads))
    case_a = jplate.build(scale=tentry.SCALE, pad_to_multiple_of=pad,
                          **tentry.ANALYTIC)
    out["analytic_loss"] = float(minimize(
        loss_of(case_a), case_a.init_params(seed=0), maxiter=3,
        segment=3).final_loss)
    return out


@pytest.fixture(scope="module")
def dryruns(jax_trees):
    """(world size -> every rank's results, the JAX pieces); the worlds run
    while the parent computes the JAX pieces."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {n: pool.submit(tentry.dryrun_multichip, n, device="cpu",
                                  trees=jax_trees) for n in WORLDS}
        ref = _jax_pieces(JAX_PAD)
        return {n: f.result() for n, f in futures.items()}, ref


def test_entry_forward_matches_jax():
    """The net-BC plate forward at JAX's ``entry`` parameters and points,
    float32 on both sides, within 2e-6·max(1, max|ref|)."""
    import __graft_entry__ as graft

    jfn, (jparams, jxyt) = graft.entry()
    want = np.asarray(jfn(jparams, jxyt))
    fn, (params, xyt) = tentry.entry(device="cpu")
    assert np.array_equal(xyt.numpy(), np.asarray(jxyt))
    assert xyt.dtype == torch.float32 and xyt.shape == (256, 3)
    jleaves = _jax_numpy(jparams)
    assert sorted(params) == sorted(jleaves) == ["dist", "part", "uv"]
    for k, net in params.items():
        assert [tuple(layer["W"].shape) for layer in net] == [
            layer["W"].shape for layer in jleaves[k]]
    with torch.no_grad():
        got = fn(params_from_jax(jleaves, device="cpu"), xyt)
        own = fn(params, xyt)
    assert got.shape == own.shape == (256, 5)
    assert got.dtype == torch.float32 and torch.isfinite(own).all()
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 2e-6 * max(1.0, float(np.abs(want).max()))


def test_entry_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tentry.entry()


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_matches_jax(dryruns, n):
    """Each piece against JAX's on one device at the same parameters:
    the Adam step's loss and components, the microbatched and
    kernel-route losses and gradient norms within 1e-5 relative, the two
    3-iteration L-BFGS losses within 1e-3."""
    ranks, ref = dryruns
    got = ranks[n][0]
    assert got["components"].keys() == ref["components"].keys()
    for k, v in ref["components"].items():
        assert got["components"][k] == pytest.approx(v, rel=REL), k
    for key in ("adam_loss", "micro_loss", "micro_grad_norm", "kernel_loss",
                "kernel_grad_norm"):
        assert got[key] == pytest.approx(ref[key], rel=REL), key
    for key in ("lbfgs_loss", "analytic_loss"):
        assert got[key] == pytest.approx(ref[key], rel=LBFGS_REL), key
    assert got["lbfgs_loss"] < got["adam_loss"]


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_ranks_bitwise_equal(dryruns, n):
    """Every rank holds the same losses, gradient norms, final parameters
    and L-BFGS evaluation counts, bit for bit; each piece made the
    reductions of its value+grads (one of the sums and one of the
    gradient each), on the CPU with no kernel launch."""
    ranks = dryruns[0][n]
    assert len(ranks) == n and [r["card"] for r in ranks] == ["cpu"] * n
    for key in tentry.SAME_ON_EVERY_RANK:
        for r in ranks[1:]:
            a, b = ranks[0][key], r[key]
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b), key
    first = ranks[0]
    evals = {"adam": 1, "lbfgs": first["lbfgs_evals"], "micro": 1,
             "kernel": 1, "analytic": first["analytic_evals"]}
    assert first["lbfgs_evals"] >= tentry.LBFGS_ITERS
    for piece, k in evals.items():
        assert first["collectives"][piece] == {"sums": k, "grads": k,
                                               "gathers": 0}, piece
        assert not any(first["launches"][piece].values()), piece
    assert np.isfinite(first["analytic_params"]).all()


def test_dryrun_lines_read_as_jax():
    """The four lines carry the JAX dry run's wording and keys (its
    recorded output, ``MULTICHIP_r05.json``)."""
    import json

    with open(os.path.join(os.path.dirname(__file__), os.pardir,
                           "MULTICHIP_r05.json")) as f:
        jax_lines = json.load(f)["tail"].strip().splitlines()
    res = {"adam_loss": 1.5, "lbfgs_loss": 0.25, "micro_loss": 2.0,
           "micro_grad_norm": 3.0, "kernel_loss": 2.0,
           "kernel_grad_norm": 3.0, "analytic_loss": 7.0,
           "components": {"HOLE": 0.1, "f_s": 0.2, "f_uv": 0.3}}
    shape = lambda line: re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)
    ours = tentry.dryrun_lines(8, res)
    assert [shape(x) for x in ours] == [shape(x) for x in jax_lines]


def test_cli_prints_the_lines_and_the_forward(capfd):
    """``python -m pinn_elastodynamics_torch.entry 2 --device cpu``: rank 0
    prints the four lines, the parent its own, then the forward."""
    assert tentry.main(["2", "--device", "cpu"]) == 0
    out = capfd.readouterr().out.splitlines()
    heads = [line.split(" OK")[0] for line in out if " OK" in line]
    assert heads == [
        "dryrun_multichip(2): sharded Adam step + L-BFGS segment",
        "dryrun_multichip(2): microbatched remat loss",
        "dryrun_multichip(2): pallas-jet value_and_grad",
        "dryrun_multichip(2): analytic-BC + Fourier L-BFGS segment"]
    assert any(line.startswith("dryrun_multichip(2): world of 2 over gloo")
               and "ranks bitwise equal" in line for line in out)
    assert out[-1] == "entry forward: (256, 5) torch.float32"


def _failing_rank(mesh, payload):
    """Rank ``payload`` raises; the others wait in a collective for it."""
    if mesh.rank == payload:
        raise ValueError(f"rank {mesh.rank} fails on purpose")
    dist.all_reduce(torch.ones(1), group=mesh.group)
    return mesh.rank


def _crashing_rank(mesh, payload):
    """Rank ``payload`` ends at once, writing nothing; the others wait in
    a collective for it."""
    if mesh.rank == payload:
        os._exit(3)
    dist.all_reduce(torch.ones(1), group=mesh.group)
    return mesh.rank


def _sleeping_rank(mesh, payload):
    time.sleep(payload)
    return mesh.rank


def test_run_world_failing_rank_fails_the_parent():
    """The parent raises with the rank's message long before the group's
    timeout would free the ranks waiting for it."""
    start = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch.run_world(_failing_rank, 3, device="cpu", payload=1)
    assert "rank 1 of a world of 3 (gloo)" in str(err.value)
    assert time.perf_counter() - start < launch.GROUP_TIMEOUT_S / 2


def test_run_world_crashed_rank_is_named():
    """A rank that dies without a traceback is the cause named, not the
    ranks its death frees with an error."""
    with pytest.raises(RuntimeError, match=r"rank 0 of a world of 3 \(gloo\) "
                                           r"failed \(exit code 3\):\nno "
                                           r"error written"):
        launch.run_world(_crashing_rank, 3, device="cpu", payload=0)


def test_run_world_deadline_stops_every_rank():
    start = time.perf_counter()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] still running"):
        launch.run_world(_sleeping_rank, 2, device="cpu", timeout_s=3,
                         payload=600)
    assert time.perf_counter() - start < 30
    assert launch.run_world(_sleeping_rank, 2, device="cpu",
                            payload=0) == [0, 1]


def test_too_few_cards_raise_before_spawning(monkeypatch):
    """NCCL takes one card per rank: with fewer, nothing is built or
    spawned; gloo may share the cards, and the CPU takes NCCL never."""
    def refuse(*args, **kwargs):
        raise AssertionError("spawned or built")

    monkeypatch.setattr(launch.multiprocessing, "get_context", refuse)
    monkeypatch.setattr("pinn_elastodynamics_torch.kernels._native.build",
                        refuse)
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 CUDA "
                                           "devices, one each; 0 present"):
        tentry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 NCCL ranks need 4 CUDA "
                                           "devices, one each; 1 present"):
        launch.run_world(_sleeping_rank, 4, payload=0)
    assert launch._plan(3, "cuda", "gloo") == ("gloo", ["cuda:0"] * 3)
    assert launch._plan(1, "cuda", None) == ("nccl", ["cuda:0"])
    with pytest.raises(ValueError, match="NCCL reduces CUDA tensors only"):
        launch.run_world(_sleeping_rank, 2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="at least one rank"):
        launch.run_world(_sleeping_rank, 0, device="cpu")


def test_seeded_trees_fit_the_models():
    """The dry run's default parameters: numpy-seeded, reproducible, in
    the layout the models take."""
    trees = tentry.seeded_trees(0)
    again = tentry.seeded_trees(0)
    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.utils.tree import tree_leaves

    for name, kw in (("net_bc", {}), ("analytic", tentry.ANALYTIC)):
        model = plate_hole.build_model(**kw)
        want = model.init(torch.Generator().manual_seed(0), torch.float32,
                          "cpu")
        got = params_from_jax(trees[name], device="cpu")
        shapes = lambda t: [tuple(x.shape) for x in tree_leaves(t)]
        assert shapes(got) == shapes(want)
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(trees[name]), tree_leaves(again[name])))
    w = trees["net_bc"]["uv"][1]["W"]
    assert w.dtype == np.float32
    assert abs(float(w.std()) - math.sqrt(2.0 / 140)) < 0.01
