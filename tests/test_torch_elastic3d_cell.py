"""PyTorch port: E1, the 3D elastic wave, against the benchmark's plain
reference (``benchmark/reference/elastic3d.py``), on the CPU at a small
size with seeded random weights.

- The cell's banks (``benchmark/adapters/elastic3d.py``) are bitwise the
  program's ``cases/elastic3d.py::build_banks``.
- The phase loss, its components and its gradient in float64 on the eager
  path equal the reference's.
- The reference's residuals vanish on the exact plane P-wave, built here
  from its closed form, and its jet of normalised inputs is autograd's.
- The benchmark's cell ``elastic3d.lbfgs``, cut to a small size, is
  correct; the reference in TF32 in the program's place and the program
  with half of each bank left out are not.
- The residual and the input normalisation open their spans under a
  profiler and nothing without one; the cell's readers read them.
- On the card (``card``), at the cell's full size: one value+grad launches
  B1 and B2 once each, B2 on the wide-tile body, and the loss is the
  float64 reference's.  This file imports no JAX, so the card test runs
  there with ``--noconftest``.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from benchmark import weights as wt
from benchmark.adapters import elastic3d as adapter
from benchmark.core import Run, metric_reader
from benchmark.drivers.train import reference_value_grad
from benchmark.reference import elastic3d as ref
from benchmark.reference.mlp import Jet as RefJet
from benchmark.tests.cells import small_run
from pinn_elastodynamics_torch.banks import make_bank
from pinn_elastodynamics_torch.cases import elastic3d
from pinn_elastodynamics_torch.kernels import fused_jet as fj
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as fv
from pinn_elastodynamics_torch.train.step import value_and_grad
from pinn_elastodynamics_torch.utils import profiling
from pinn_elastodynamics_torch.utils.profiling import SpanRecord

CPU = torch.device("cpu")
F64 = torch.float64
CELL = "elastic3d.lbfgs"
SCALE = 0.003
DIMS = [4] + [100] * 6 + [12]
# Both sides in float64, differing only by the order of rounding (the
# program scales the seed's tangents before the net, the reference the
# jet's after it): the loss, a sum of ~10^3 squares, agrees to ~1e-14;
# 1e-10 leaves room and still sees any changed term.
REL = 1e-10
# The plane wave's fields and derivatives are O(1) (amplitude 0.1, k up
# to 2π, ω = √3·k): float64 rounding of its residuals is ~1e-15.
ATOL_WAVE = 1e-12
START, END = 100.0, 200.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and while other test
    workers hold every core a parallel region of a small op waits for its
    threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("seed,scale", [(7, 0.003), (1111, 0.02),
                                        (2**31 + 11, 0.05), (1111, 1.0)])
def test_banks_are_the_programs(cfg, seed, scale):
    ours = adapter.banks(dict(cfg, scale=scale), seed)
    theirs = elastic3d.build_banks(seed=seed, scale=scale, dtype=F64,
                                   device="cpu")
    assert sorted(ours) == sorted(theirs) == ["collocation", "ic", "src"]
    for name, arrays in ours.items():
        b = theirs[name]
        n = arrays["xyt"].shape[0]
        assert arrays["xyt"].shape[1] == 4
        assert int(b.mask.sum()) == n == b.n_total
        np.testing.assert_array_equal(b.xyt.numpy(), arrays["xyt"])
    np.testing.assert_array_equal(theirs["src"].values["uvw"].numpy(),
                                  ours["src"]["uvw"])
    if (seed, scale) == (1111, 1.0):   # the configuration's stated rows
        assert {k: v["xyt"].shape[0] for k, v in ours.items()} == {
            "collocation": 225_074, "src": 50_000, "ic": 19_983}


def _program_case(host):
    case = elastic3d.build(scale=1e-3, dtype=F64, device="cpu")
    case.banks = {k: make_bank(v["xyt"], {n: a for n, a in v.items()
                                          if n != "xyt"},
                               dtype=F64, pad_to_multiple_of=8, device="cpu")
                  for k, v in host.items()}
    return case


def _reference_components(net, host):
    """Each component of the loss, the reference's residuals and fields
    summed by hand."""
    x = torch.as_tensor(host["collocation"]["xyt"], dtype=F64)
    f_uv, f_s = ref.residuals(ref.field_jet(net, x, "float64"))
    out = {"f_uv": sum(torch.mean(r * r) for r in f_uv),
           "f_s": sum(torch.mean(r * r) for r in f_s)}
    src = ref.forward(net, ref.normalise(
        torch.as_tensor(host["src"]["xyt"], dtype=F64)), "float64")
    target = torch.as_tensor(host["src"]["uvw"], dtype=F64)
    out["SRC"] = sum(torch.mean((src[:, c] - target[:, c]) ** 2)
                     for c in range(3))
    ic = ref.forward(net, ref.normalise(
        torch.as_tensor(host["ic"]["xyt"], dtype=F64)), "float64")
    out["IC"] = sum(torch.mean(ic[:, c] ** 2) for c in range(6))
    return out


@pytest.mark.parametrize("seed", [5, 77, 2**31 + 11])
def test_loss_components_and_gradient_match_the_reference_in_float64(cfg,
                                                                     seed):
    """The program's phase loss over every parameter, float64 banks and
    weights on the eager path, against the reference: the loss, each
    component and every gradient leaf within REL."""
    host = adapter.banks(cfg, seed)
    case = _program_case(host)
    w64 = _weights64(cfg, seed)
    params = wt.program_tree(w64["net"])
    (loss, comps), grads = value_and_grad(case.loss_and_aux_fn(), params,
                                          has_aux=True)
    want = _reference_components(w64["net"], host)
    assert sorted(comps) == sorted(want)
    for k, v in want.items():
        assert abs(float(comps[k]) - float(v)) <= REL * abs(float(v)), k
    x = torch.cat([t.reshape(-1) for w, b in w64["net"] for t in (w, b)])
    f, g = reference_value_grad(adapter, ref, w64, host, x.numpy(), CPU, True)
    assert abs(float(loss) - f) <= REL * abs(f)
    assert abs(f - sum(5.0 * float(want[k]) if k in ("f_uv", "f_s")
                       else float(want[k]) for k in want)) <= REL * abs(f)
    g_prog = torch.cat([t.reshape(-1) for layer in grads
                        for t in (layer["W"], layer["b"])]).numpy()
    np.testing.assert_allclose(g_prog, g, rtol=0, atol=REL * np.abs(g).max())


def _plane_wave_jet(x, n_dir, k, speed_sq=None):
    """The first-order jet of the plane P-wave u = A·n·sin(k·n·x - ω·t)
    in raw coordinates, ω² = k²·(λ + 2G)/ρ (or ``speed_sq``·k²), from its
    closed form: σ_ij = A·k·(λ·δ_ij + 2G·n_i·n_j)·cos(phase)."""
    amp = 0.1
    n = torch.as_tensor(n_dir, dtype=F64)
    n = n / torch.linalg.norm(n)
    cp2 = (ref.LAMBDA + 2 * ref.G) / ref.RHO if speed_sq is None else speed_sq
    w = k * cp2 ** 0.5
    phase = k * (x[:, :3] @ n) - w * x[:, 3]
    sin, cos = torch.sin(phase), torch.cos(phase)
    f = torch.zeros(x.shape[0], 12, dtype=F64)
    d = [torch.zeros_like(f) for _ in range(4)]
    for i in range(3):
        f[:, ref.U + i] = amp * n[i] * sin
        f[:, ref.UT + i] = -amp * n[i] * w * cos
        for j in range(3):
            d[j][:, ref.U + i] = amp * n[i] * k * n[j] * cos
            d[j][:, ref.UT + i] = amp * n[i] * w * k * n[j] * sin
        d[3][:, ref.U + i] = -amp * n[i] * w * cos
        d[3][:, ref.UT + i] = -amp * n[i] * w * w * sin
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    for c, (i, j) in zip((ref.S11, ref.S22, ref.S33, ref.S12, ref.S13,
                          ref.S23), pairs):
        cij = amp * k * ((ref.LAMBDA if i == j else 0.0)
                         + 2 * ref.G * n[i] * n[j])
        f[:, c] = cij * cos
        for m in range(3):
            d[m][:, c] = -cij * k * n[m] * sin
        d[3][:, c] = cij * w * sin
    return RefJet(f, d)


def _box_points(seed, n=256):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(ref.LB, ref.UB, (n, 4)), dtype=F64)


@pytest.mark.parametrize("n_dir,k", [((1.0, 2.0, 2.0), np.pi),
                                     ((0.0, 0.0, 1.0), 0.5),
                                     ((-3.0, 1.0, 0.5), 2 * np.pi)])
def test_reference_residuals_vanish_on_the_plane_wave(n_dir, k):
    x = _box_points(int(10 * k))
    f_uv, f_s = ref.residuals(_plane_wave_jet(x, n_dir, k))
    assert len(f_uv) == 6 and len(f_s) == 6
    for r in f_uv + f_s:
        assert float(r.abs().max()) <= ATOL_WAVE
    # the wrong wave speed leaves the constitutive and velocity residuals
    # at zero and breaks the momentum balance
    f_uv, f_s = ref.residuals(_plane_wave_jet(x, n_dir, k, speed_sq=2.0))
    assert max(float(r.abs().max()) for r in f_s + f_uv[3:]) <= ATOL_WAVE
    assert max(float(r.abs().max()) for r in f_uv[:3]) > 1e-3


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_reference_jet_is_autograds(cfg, seed):
    """The reference's jet of normalised inputs, its tangents scaled by
    2/(ub - lb), is the derivative of its forward in raw coordinates."""
    net = _weights64(cfg, seed)["net"]
    x = _box_points(seed, 12)
    j = ref.field_jet(net, x, "float64")
    fwd = lambda p: ref.forward(net, ref.normalise(p), "float64")
    # the same products in the same order: the values agree to float64
    # rounding of O(1) outputs
    torch.testing.assert_close(fwd(x), j.f, rtol=0, atol=1e-14)
    for r in range(x.shape[0]):
        jac = torch.autograd.functional.jacobian(lambda p: fwd(p[None])[0],
                                                 x[r])
        # forward against reverse mode, each a chain of seven products of
        # O(1) factors: ~1e-15 apart; 1e-12 still sees a tangent scaled
        # wrongly (2/30 against 2/10 differs by ~1e-1)
        for i in range(4):
            np.testing.assert_allclose(j.d[i][r].numpy(), jac[:, i].numpy(),
                                       rtol=0, atol=1e-12)


def test_counts_by_hand():
    banks = {"collocation": {"xyt": np.zeros((1000, 4))},
             "src": {"xyt": np.zeros((50, 4))},
             "ic": {"xyt": np.zeros((20, 4))}}
    got = adapter.train_flops({"nets": {"net": DIMS}}, banks)
    w = 4 * 100 + 5 * 100 * 100 + 100 * 12
    assert w == 51_600
    # value+grad at 5 streams (collocation) and 1 (source and IC), less the
    # first layer's input cotangent: the inputs are coordinates
    assert got["step"] == 1000 * (30 * w - 10 * 400) + 70 * (6 * w - 2 * 400)
    # B2: 6 per hidden weight and 4 per head weight, a stream
    assert got["bwd"] == 1000 * 5 * (6 * (400 + 50_000) + 4 * 1200)
    # five seed streams of 4 inputs read, the value rows' cotangent
    # written, five streams of 12 cotangents read, in float32
    assert got["bwd_bytes"] == 1000 * 4 * (5 * 4 + 4 + 5 * 12)
    # at seed 1111 the backward is 3.457e11 operations, 5.16 ms at the peak
    assert 225_074 * got["bwd"] / 1000 == pytest.approx(3.457e11, rel=1e-3)


@pytest.mark.parametrize("kind", ["program", "control", "half_batch"])
def test_small_cell_is_correct_and_its_faults_are_not(bench, kind):
    run = small_run(bench, CELL, seed=2**31 + 103)
    if kind == "program":
        bench_run.execute(run, bench)
        assert run.correct, run.checks
    elif kind == "control":
        bench_run.execute(run, bench, control=True)
        assert not run.correct, run.checks
    else:
        bench_run.execute(run, bench, fault=kind)
        assert not run.correct, run.checks


def test_program_refuses_other_bounds(cfg):
    norm = {"lb": [-15.0, -15.0, -15.0, 0.0], "ub": [15.0, 15.0, 15.0, 14.0]}
    w = wt.make(cfg["nets"], 1, CPU)
    with pytest.raises(ValueError, match="normalises"):
        adapter.program(dict(cfg, input_normalisation=norm),
                        adapter.banks(cfg, 1), w, CPU)


@pytest.mark.parametrize("n", [5, 40])
def test_residual_and_normalisation_open_their_spans(cfg, n):
    case = _program_case(adapter.banks(cfg, n))
    params = wt.program_tree(_weights64(cfg, 1)["net"])
    x = _box_points(n, n)
    rows = {k: b.n_total for k, b in case.banks.items()}

    def calls():
        case.model.jet(params, x)
        case.model.apply(params, x)
        case.loss.evaluate(case.model, params, case.material, case.banks)

    t0 = time.perf_counter()
    calls()
    assert not [s for s in profiling.spans() if s.start >= t0]
    with profile(activities=[ProfilerActivity.CPU]):
        calls()
    got = [(s.name, s.counts) for s in profiling.spans() if s.start >= t0]
    assert got == [("model.normalize", {"rows": n, "order": 1}),
                   ("model.normalize", {"rows": n, "order": 0}),
                   ("model.normalize", {"rows": rows["collocation"],
                                        "order": 1}),
                   ("loss.residual", {"ndim": 3,
                                      "rows": rows["collocation"]}),
                   ("model.normalize", {"rows": rows["src"], "order": 0}),
                   ("model.normalize", {"rows": rows["ic"], "order": 0})]
    # the residual opens after the jet: no span holds another
    assert all(s.parent == 0 for s in profiling.spans() if s.start >= t0)


def test_unnormalised_models_open_no_normalisation_span():
    from pinn_elastodynamics_torch.cases import wave_confined

    model = wave_confined.build_model()
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dtype=F64, device="cpu")
    x = torch.rand(9, 3, dtype=F64)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        model.jet(params, x)
        model.apply(params, x)
    assert not [s for s in profiling.spans() if s.start >= t0]


# -- the cell's readers on synthetic runs ---------------------------------------

def _run() -> Run:
    run = Run(cell={"name": "synthetic"}, config={}, traffic={}, seed=1,
              seconds=1.0, trace=True, device=CPU, chips=1,
              t_start=time.perf_counter(), limits={})
    run.counts.update(plain_end=START, spans_start=END)
    return run


def _value_and_grad(at: float, ids: list) -> list:
    """One ``vg`` of 40 ms: the collocation jet's normalisation (1 ms),
    the residual (6 ms), the two plain forwards' normalisations (0.5 ms
    each), and the backward's normalisation (2 ms) on the device's own
    thread, its own root."""
    out, root = [], ids[0] + 1

    def add(name, t0, t1, parent, r, **counts):
        ids[0] += 1
        out.append(SpanRecord(name, at + t0 * 1e-3, at + t1 * 1e-3, ids[0],
                              parent, r, 1, counts))

    add("vg", 0, 40, 0, root)
    add("model.normalize", 1, 2, root, root, rows=10, order=1)
    add("loss.residual", 10, 16, root, root, ndim=3, rows=10)
    add("model.normalize", 17, 17.5, root, root, rows=5, order=0)
    add("model.normalize", 18, 18.5, root, root, rows=5, order=0)
    add("model.normalize", 30, 32, 0, ids[0] + 1, rows=10, order=1)
    return out


@pytest.fixture
def recorded(monkeypatch):
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return records


def test_span_readers(recorded):
    ids = [0]
    recorded += (_value_and_grad(START - 1.0, ids)       # before the part
                 + _value_and_grad(START + 1.0, ids)
                 + _value_and_grad(START + 2.0, ids))
    run = _run()
    assert metric_reader("residual_host_ms.train")(run) == pytest.approx(6.0)
    assert metric_reader("normalize_host_ms.train")(run) == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["residual_host_ms.train",
                                  "normalize_host_ms.train"])
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


@pytest.mark.parametrize("name", ["mfu.train", "device_idle.train",
                                  "vg_ms.train", "vg_host_ms.train",
                                  "B2_roofline.train"])
def test_the_cells_metrics_read_as_their_base(recorded, name):
    run = _run()
    run.flops = {"step": 3.7e11, "bwd": 67e9, "bwd_bytes": 0.0}
    run.counts.update(plain_evals=200, window_start=START - 10.0)
    run.spans.add("loss_eval", END + 1.0, END + 1.05)
    run.device_trace = {"cards": 1, "busy_s": 2.4, "window_s": 3.0,
                        "kernels": {
                            "void mlp_jet_bwd_kernel<5, false, 16>(float)":
                                (2, 0.003),
                            "void reduce_partials(float)": (2, 0.001),
                            "void mlp_jet_kernel<5, false, 32>(float)":
                                (2, 0.5)}}
    recorded += _value_and_grad(START + 1.0, [0])
    base, ours = metric_reader(name)(run), metric_reader(f"{name}.elastic3d")
    assert base is not None and ours(run) == base
    if name == "B2_roofline.train":
        # 2 launches x 1 ms of work at the peak over 4 ms
        assert base == pytest.approx(50.0)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_full_cell_runs_b1_and_b2_on_the_tile_body(cfg, card):
    """One value+grad of the cell's phase loss at its full size, float32
    kernels with TF32 off: exactly one B1 and one B2, B2 on the wide-tile
    body; the loss within the cell's ``loss_gap`` limit of the float64
    reference."""
    full = dict(cfg, scale=1.0)
    seed = 2**31 + 5
    host = adapter.banks(full, seed)
    w = wt.make(full["nets"], seed, card)
    limits = bench_run.load_json(bench_run.HERE / "limits" / f"{CELL}.json")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sub_fn, sub0 = adapter.program(full, host, w, card)
        fj.reset_launches()
        fv.reset_launches()
        loss, _ = value_and_grad(sub_fn, sub0)
        torch.cuda.synchronize(card)
        launches = {**fj.LAUNCHES, **fv.LAUNCHES}
        want = dict.fromkeys(launches, 0)
        want.update(fused_mlp_jet=1, fused_mlp_jet_bwd=1)
        assert launches == want
        assert fv.BODIES == {"tile": 1, "wide140": 0}
        w64 = {k: [(a.double(), b.double()) for a, b in v]
               for k, v in w.items()}
        x = torch.cat([t.reshape(-1) for a, b in w64["net"] for t in (a, b)])
        f, _ = reference_value_grad(adapter, ref, w64, host,
                                    x.cpu().numpy(), card, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(float(loss) - f) <= limits["loss_gap"] * abs(f)
