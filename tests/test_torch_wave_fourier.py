"""PyTorch port: the confined wave with hard BCs and 64 Fourier features
(W2) against the benchmark's plain reference
(``benchmark/reference/wave_confined_fourier.py``), on the CPU at a small
size with seeded random weights.

- The phase loss that trains ``uv.mlp`` with B frozen, and its gradient,
  in float64 on the eager path, equal the reference's.
- The closed-form factors' jets (``jet_of_fn`` of ``analytic_dist`` and
  ``analytic_part``) and the embedding's jet equal the reference's
  written-out jets.
- The benchmark's cell ``wave_confined_fourier.lbfgs``, cut to a small
  size, is correct; the reference in TF32 in the program's place and the
  program with half of each bank left out are not.
- The seeded jet's backward counts, in ``SEED_GRADS``, whether any caller
  asked for the seed cotangent; the embedding and the factors open their
  spans under a profiler.
- On the card (``card``), at the cell's full size: one value+grad launches
  the seeded B1 and B3b once each, B3b on the wide140 body, its seed
  cotangent unneeded, and the loss is the float64 reference's; the next
  value+grad reads the closed-form factors back from the store.  This file
  imports no JAX, so the card test runs there with ``--noconftest``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from benchmark import weights as wt
from benchmark.adapters import wave_confined_fourier as adapter
from benchmark.drivers.train import reference_value_grad
from benchmark.reference import wave_confined_fourier as ref
from benchmark.tests.cells import small_run
from pinn_elastodynamics_torch.banks import make_bank
from pinn_elastodynamics_torch.cases import wave_confined
from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
from pinn_elastodynamics_torch.kernels import fused_jet as fj
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
from pinn_elastodynamics_torch.models import analytic_bc
from pinn_elastodynamics_torch.models.analytic_bc import FACTOR_JETS
from pinn_elastodynamics_torch.ops.jet import jet_of_fn
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils import profiling

CPU = torch.device("cpu")
F64 = torch.float64
CELL = "wave_confined_fourier.lbfgs"
SCALE = 0.003
# Both sides in float64, differing only by the order of rounding: the
# loss, a sum of ~10^3 squares, agrees to ~1e-14; 1e-10 leaves room and
# still sees any changed term.
REL = 1e-10
# The factors and the embedding are O(1) elementwise functions (the
# embedding's tangents O(2π·64/15)): float64 rounding is ~1e-15 of them.
ATOL_ELEMENTWISE = 1e-12


@pytest.fixture(scope="module")
def bench():
    return bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")


@pytest.fixture(scope="module")
def cfg(bench):
    _, config, _, _ = bench_run.cell_files(bench, CELL)
    return dict(config, scale=SCALE)


def _weights64(cfg, seed):
    w = wt.make(cfg["nets"], seed, CPU)
    return {k: [(a.double(), b.double()) for a, b in v] for k, v in w.items()}


def _model():
    return wave_confined.build_model(bc="hard", fourier=64, fourier_scale=1.0,
                                     jet_impl="eager")


def _points(seed, n=64):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform((-15, -15, 0), (15, 15, 14), (n, 3)),
                           dtype=F64)


@pytest.mark.parametrize("seed", [5, 77, 2**31 + 11])
def test_loss_and_gradient_match_the_reference_in_float64(cfg, seed):
    """The program's phase loss over uv.mlp (B frozen), float64 banks and
    weights on the eager path, against the reference: the loss and every
    gradient leaf within REL."""
    host = adapter.banks(cfg, seed)
    case = wave_confined.build(scale=1e-3, bc="hard", fourier=64,
                               fourier_scale=1.0, dtype=F64, device="cpu")
    case.banks = {k: make_bank(v["xyt"], {n: a for n, a in v.items()
                                          if n != "xyt"},
                               dtype=F64, pad_to_multiple_of=8, device="cpu")
                  for k, v in host.items()}
    w64 = _weights64(cfg, seed)
    params = {"uv": {"B": adapter.feature_matrix(w64),
                     "mlp": wt.program_tree(w64["mlp"])}}
    phase = dataclasses.replace(case.phases[-1], trainable="uv.mlp")
    sub_fn, sub0, _ = _phase_loss_fn(case, phase, params)
    loss, grads = value_and_grad(sub_fn, sub0)
    x = torch.cat([t.reshape(-1) for w, b in w64["mlp"] for t in (w, b)])
    f, g = reference_value_grad(adapter, ref, w64, host, x.numpy(), CPU, True)
    assert abs(float(loss) - f) <= REL * abs(f)
    g_prog = torch.cat([t.reshape(-1) for layer in grads
                        for t in (layer["W"], layer["b"])]).numpy()
    np.testing.assert_allclose(g_prog, g, rtol=0, atol=REL * np.abs(g).max())


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_factor_jets_match_the_written_out_jets(seed):
    x = _points(seed)
    dist = jet_of_fn(wave_confined.analytic_dist, x, order=1)
    part = jet_of_fn(wave_confined.analytic_part, x, order=1)
    want = ref.dist_jet(x)
    np.testing.assert_allclose(dist.f.numpy(), want.f.numpy(), rtol=0,
                               atol=ATOL_ELEMENTWISE)
    for i in range(3):
        np.testing.assert_allclose(dist.d[i].numpy(), want.d[i].numpy(),
                                   rtol=0, atol=ATOL_ELEMENTWISE)
    # P = 0 with zero tangents
    assert not part.f.any() and not part.d.any()


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_embedding_jet_matches_the_written_out_jet(cfg, seed):
    x = _points(seed)
    b = adapter.feature_matrix(_weights64(cfg, seed))
    h, d, dtt = _model().uv_model._embed_jet({"B": b}, x, 1)
    want = ref.embed_jet(b, x, "float64")
    assert dtt is None
    np.testing.assert_allclose(h.numpy(), want.f.numpy(), rtol=0,
                               atol=ATOL_ELEMENTWISE)
    for i in range(3):
        np.testing.assert_allclose(d[i].numpy(), want.d[i].numpy(), rtol=0,
                                   atol=ATOL_ELEMENTWISE)


@pytest.mark.parametrize("kind", ["program", "control", "half_batch"])
def test_small_cell_is_correct_and_its_faults_are_not(bench, kind):
    run = small_run(bench, CELL, seed=2**31 + 101)
    if kind == "program":
        bench_run.execute(run, bench)
        assert run.correct, run.checks
    elif kind == "control":
        bench_run.execute(run, bench, control=True)
        assert not run.correct, run.checks
    else:
        bench_run.execute(run, bench, fault=kind)
        assert not run.correct, run.checks


@pytest.mark.parametrize("seeded,counted", [(None, "unneeded"),
                                            ("h0", "needed"),
                                            ("d", "needed")])
def test_seed_grads_counts_whether_the_seed_cotangent_was_asked_for(
        seeded, counted):
    gen = torch.Generator().manual_seed(11)
    dims = [8, 16, 16, 3]
    params = [{"W": torch.randn(i, o, generator=gen, dtype=F64),
               "b": torch.randn(o, generator=gen, dtype=F64)}
              for i, o in zip(dims[:-1], dims[1:])]
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    h0 = torch.randn(20, 8, generator=gen, dtype=F64)
    d = torch.randn(3, 20, 8, generator=gen, dtype=F64)
    inputs = {"h0": h0, "d": d}
    if seeded is not None:
        inputs[seeded].requires_grad_()
    fv.reset_seed_grads()
    before = dict(fv.LAUNCHES)
    jet = fv.fused_seed_jet_vjp(params, h0, d)
    loss = (jet.f ** 2).sum() + (jet.d ** 2).sum()
    wrt = leaves + ([inputs[seeded]] if seeded is not None else [])
    grads = torch.autograd.grad(loss, wrt)
    assert fv.SEED_GRADS == {"needed": int(counted == "needed"),
                             "unneeded": int(counted == "unneeded")}
    # the parameters' gradients do not depend on what else was asked for
    fv.reset_seed_grads()
    jet = fv.fused_seed_jet_vjp(params, h0.detach(), d.detach())
    alone = torch.autograd.grad((jet.f ** 2).sum() + (jet.d ** 2).sum(),
                                leaves)
    for a, b in zip(grads, alone):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fv.SEED_GRADS["unneeded"] == 1
    assert fv.LAUNCHES == before        # the plain version launches nothing
    fv.reset_seed_grads()
    assert fv.SEED_GRADS == {"needed": 0, "unneeded": 0}


@pytest.mark.parametrize("n", [5, 40])
def test_embedding_and_factors_open_their_spans(cfg, n):
    model = _model()
    w64 = _weights64(cfg, 1)
    params = {"uv": {"B": adapter.feature_matrix(w64),
                     "mlp": wt.program_tree(w64["mlp"])}}
    x = _points(n, n)
    t0 = time.perf_counter()
    model.jet(params, x)
    model.apply(params, x)
    assert not [s for s in profiling.spans() if s.start >= t0]
    with profile(activities=[ProfilerActivity.CPU]):
        model.jet(params, x)
        model.apply(params, x)
    got = [(s.name, s.counts) for s in profiling.spans() if s.start >= t0]
    assert got == [("model.embed", {"rows": n, "order": 1}),
                   ("model.factors", {"rows": n, "order": 1}),
                   ("model.embed", {"rows": n, "order": 0}),
                   ("model.factors", {"rows": n, "order": 0})]


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_full_cell_runs_the_seeded_kernels_on_the_card(cfg, card):
    """One value+grad of the cell's phase loss at its full size, float32
    kernels with TF32 off: exactly one seeded B1 and one B3b, on the
    wide140 body, B3b's seed cotangent counted unneeded, the factors of
    both banks computed and stored; the loss within 1e-5 of the float64
    reference (the cell's ``loss_gap`` limit).  A second value+grad reads
    the factors back and gives the same loss."""
    full = dict(cfg, scale=1.0)
    seed = 2**31 + 5
    host = adapter.banks(full, seed)
    w = wt.make(full["nets"], seed, card)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sub_fn, sub0 = adapter.program(full, host, w, card)
        fj.reset_launches()
        fv.reset_launches()
        fv.reset_seed_grads()
        analytic_bc.reset_factor_jets()
        loss, _ = value_and_grad(sub_fn, sub0)
        torch.cuda.synchronize(card)
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        want = dict.fromkeys(launches, 0)
        want.update(fused_mlp_jet=1, fused_seed_jet_bwd=1)
        assert launches == want
        assert fv.BODIES == {"tile": 0, "wide140": 1}
        assert fv.SEED_GRADS == {"needed": 0, "unneeded": 1}
        assert FACTOR_JETS == {"hit": 0, "miss": 2, "bypass": 0}
        # the next value+grad reads both banks' factors back
        again, _ = value_and_grad(sub_fn, sub0)
        assert FACTOR_JETS == {"hit": 2, "miss": 2, "bypass": 0}
        assert torch.equal(again, loss)
        w64 = {k: [(a.double(), b.double()) for a, b in v]
               for k, v in w.items()}
        x = torch.cat([t.reshape(-1) for a, b in w64["mlp"] for t in (a, b)])
        f, _ = reference_value_grad(adapter, ref, w64, host,
                                    x.cpu().numpy(), card, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(float(loss) - f) <= 1e-5 * abs(f)
