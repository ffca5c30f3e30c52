"""W2's cell, ``wave_confined_fourier.lbfgs``, on the CPU: its banks are the
program's, B is laid out from the net ``embed``, its operation counts
match counts made by hand, the reference's written-out jets match autograd,
and its new readers read what they should and nothing (None, no error)
where the program has no such span or counter."""

import math
import time

import numpy as np
import pytest
import torch

from benchmark import weights as wt
from benchmark.adapters import wave_confined_fourier as adapter
from benchmark.core import Run, metric_reader
from benchmark.reference import wave_confined_fourier as ref
from pinn_elastodynamics_torch.kernels import fused_jet_vjp
from pinn_elastodynamics_torch.utils import profiling
from pinn_elastodynamics_torch.utils.profiling import SpanRecord

MLP = [128] + [140] * 6 + [7]
CFG = {"scale": 0.003, "max_t": 14.0, "pad_to_multiple_of": 8,
       "nets": {"mlp": MLP, "embed": [3, 64]}}
SPAN_READERS = ("embed_host_ms.train", "factors_host_ms.train")
START, END = 100.0, 200.0


def test_banks_are_the_programs_collocation_and_source_rows():
    from pinn_elastodynamics_torch.cases import wave_confined

    seed = 4243
    ours = adapter.banks(CFG, seed)
    theirs = wave_confined.build(seed=seed, scale=CFG["scale"], bc="hard",
                                 fourier=64, device="cpu").banks
    assert sorted(ours) == ["collocation", "src"]
    for name, arrays in ours.items():
        b = theirs[name]
        n = arrays["xyt"].shape[0]
        assert int(b.mask.sum()) == n
        np.testing.assert_array_equal(b.xyt[:n].numpy(),
                                      arrays["xyt"].astype(np.float32))
    np.testing.assert_array_equal(theirs["src"].values["uv"][:n].numpy(),
                                  ours["src"]["uv"].astype(np.float32))


def test_feature_matrix_is_the_embed_weight_over_its_glorot_factor():
    w = wt.make(CFG["nets"], 9, torch.device("cpu"))
    b = adapter.feature_matrix(w)
    assert b.shape == (3, 64) and b.dtype == torch.float32
    torch.testing.assert_close(b * math.sqrt(2.0 / 67.0), w["embed"][0][0])
    # a unit normal truncated to [-2, 2], times the feature scale 1.0
    assert float(b.abs().max()) <= 2.0 + 1e-6
    assert 0.7 < float(b.std()) < 1.1
    nets = adapter.reference_nets(w, "trainable", "float64", "cpu")
    assert nets["B"].dtype == torch.float64 and nets["mlp"] == "trainable"
    torch.testing.assert_close(nets["B"], b.double(), rtol=0, atol=0)


def test_counts_by_hand():
    banks = {"collocation": {"xyt": np.zeros((1000, 3))},
             "src": {"xyt": np.zeros((50, 3))}}
    got = adapter.train_flops(CFG, banks)
    w = 128 * 140 + 5 * 140 * 140 + 140 * 7
    assert w == 116900
    embed = 2 * 3 * 64 + 2 * 64          # xn·B, one sine and one cosine
    # value+grad at 4 streams (collocation) and 1 (source), less the first
    # layer's input cotangent: B is frozen
    col = 6 * 4 * w - 2 * 4 * 128 * 140 + embed
    src = 6 * w - 2 * 128 * 140 + embed
    assert got["step"] == 1000 * col + 50 * src
    # B3b as the loss needs it: 6 per hidden weight and 4 per head weight a
    # stream, less the seed cotangent of the first layer
    hidden = 128 * 140 + 5 * 140 * 140
    assert got["bwd"] == 1000 * (24 * hidden + 16 * 980 - 8 * 128 * 140)
    assert got["bwd_bytes"] == 1000 * 4 * 4 * (128 + 7)


def test_reference_jets_match_autograd():
    gen = torch.Generator().manual_seed(4)
    w = wt.make(CFG["nets"], 4, torch.device("cpu"))
    nets = adapter.reference_nets(w, [(a.double(), b.double())
                                      for a, b in w["mlp"]], "float64", "cpu")
    x = (torch.rand(12, 3, generator=gen, dtype=torch.float64)
         * torch.tensor([30.0, 30.0, 14.0]) - torch.tensor([15.0, 15.0, 0.0]))
    j = ref.composite_jet(nets, x, "float64")
    torch.testing.assert_close(ref.composite_forward(nets, x, "float64"), j.f,
                               rtol=0, atol=1e-14)
    for r in range(12):
        p = x[r].clone().requires_grad_()
        f = ref.composite_forward(nets, p[None], "float64")[0]
        for c in range(7):
            (d,) = torch.autograd.grad(f[c], p, retain_graph=True)
            for i in range(3):
                assert abs(float(d[i]) - float(j.d[i][r, c])) < 1e-11


def _run() -> Run:
    run = Run(cell={"name": "synthetic"}, config={}, traffic={}, seed=1,
              seconds=1.0, trace=True, device=torch.device("cpu"), chips=1,
              t_start=time.perf_counter(), limits={})
    run.counts.update(plain_end=START, spans_start=END)
    return run


def _value_and_grad(at: float, ids: list) -> list:
    """One ``vg`` of 20 ms: the collocation jet's embedding (2 ms) and
    factors (5 ms), then the source rows' (1 ms and 3 ms)."""
    out, root = [], ids[0] + 1

    def add(name, t0, t1, parent, **counts):
        ids[0] += 1
        out.append(SpanRecord(name, at + t0 * 1e-3, at + t1 * 1e-3, ids[0],
                              parent, root, 1, counts))

    add("vg", 0, 20, 0)
    add("model.embed", 1, 3, root, rows=10, order=1)
    add("model.factors", 4, 9, root, rows=10, order=1)
    add("model.embed", 10, 11, root, rows=5, order=0)
    add("model.factors", 11, 14, root, rows=5, order=0)
    return out


@pytest.fixture
def recorded(monkeypatch):
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return records


def test_span_readers(recorded):
    ids = [0]
    recorded += (_value_and_grad(START - 1.0, ids)
                 + _value_and_grad(START + 1.0, ids)
                 + _value_and_grad(START + 2.0, ids))
    run = _run()
    assert metric_reader("embed_host_ms.train")(run) == pytest.approx(3.0)
    assert metric_reader("factors_host_ms.train")(run) == pytest.approx(8.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_without_their_spans(recorded, monkeypatch,
                                                       name):
    run = _run()
    assert metric_reader(name)(run) is None             # no span recorded
    vg_only = [s for s in _value_and_grad(START + 1.0, [0]) if s.name == "vg"]
    recorded += vg_only
    assert metric_reader(name)(run) is None             # a parent's vg alone
    recorded += _value_and_grad(START + 2.0, [10])
    assert metric_reader(name)(run) is not None
    monkeypatch.delattr(profiling, "spans")             # no recorder
    assert metric_reader(name)(run) is None


def test_seed_grad_share(monkeypatch):
    read = metric_reader("seed_grad_unneeded_share.train")
    monkeypatch.setattr(fused_jet_vjp, "SEED_GRADS",
                        {"needed": 1, "unneeded": 3})
    assert read(_run()) == 75.0
    monkeypatch.setattr(fused_jet_vjp, "SEED_GRADS",
                        {"needed": 0, "unneeded": 0})
    assert read(_run()) is None                         # no backward ran
    monkeypatch.delattr(fused_jet_vjp, "SEED_GRADS")    # a parent program
    assert read(_run()) is None


def test_b3b_roofline_reads_the_backward_kernels():
    run = _run()
    read = metric_reader("B3b_roofline.train")
    assert read(run) is None                            # no device trace
    run.flops = {"bwd": 67e9, "bwd_bytes": 0.0}
    run.device_trace = {"kernels": {
        "void mlp_jet_bwd_kernel<4, false, 16, 2>(float)": (2, 0.003),
        "void reduce_partials(float)": (2, 0.001),
        "void mlp_jet_kernel<4, false, 32>(float)": (2, 0.5)}}
    # 2 launches x 1 ms of work at the peak over 4 ms
    assert read(run) == pytest.approx(50.0)
    run.device_trace = {"kernels": {}}
    assert read(run) is None
