"""The benchmark's plain reference against the program, on the CPU at a
small size: the same banks, weights and points on both sides, in float64
(where the two differ only by rounding) and on the benchmark's own float32
path."""

import numpy as np
import pytest
import torch

from benchmark import weights as wt
from benchmark.adapters import plate_netbc, wave_confined
from benchmark.drivers.train import reference_value_grad
from benchmark.reference import mlp
from benchmark.reference import plate_netbc as ref_plate
from benchmark.reference import wave_confined as ref_wave

CPU = torch.device("cpu")
SCALE = 0.003
PLATE = {"scale": SCALE, "pad_to_multiple_of": 8, "max_t": 10.0,
         "nets": {"uv": [3] + [70] * 8 + [5], "dist": [3] + [20] * 4 + [5],
                  "part": [3] + [20] * 4 + [5]}}
WAVE = {"scale": SCALE, "pad_to_multiple_of": 8, "max_t": 14.0,
        "nets": {"net": [3] + [140] * 6 + [7]}}
CASES = [(plate_netbc, ref_plate, PLATE), (wave_confined, ref_wave, WAVE)]


def _program_case(adapter, cfg, seed):
    from pinn_elastodynamics_torch.cases import plate_hole, wave_confined as wc

    if adapter is plate_netbc:
        return plate_hole.build(seed=seed, scale=SCALE, device="cpu")
    return wc.build(seed=seed, scale=SCALE, device="cpu")


@pytest.mark.parametrize("adapter,ref,cfg", CASES)
def test_frozen_samplers_draw_the_programs_banks(adapter, ref, cfg):
    seed = 4242
    ours = adapter.banks(cfg, seed)
    theirs = _program_case(adapter, cfg, seed).banks
    for name, arrays in ours.items():
        b = theirs[name]
        n = arrays["xyt"].shape[0]
        assert int(b.mask.sum()) == n
        np.testing.assert_array_equal(
            b.xyt[:n].numpy(), arrays["xyt"].astype(np.float32))
        for k, v in arrays.items():
            if k != "xyt":
                np.testing.assert_array_equal(
                    b.values[k][:n].numpy(), np.asarray(v, np.float32))


def _flat(net):
    return torch.cat([t.reshape(-1) for w, b in net for t in (w, b)])


def _weights64(cfg, seed):
    w = wt.make(cfg["nets"], seed, CPU)
    return {k: [(a.double(), b.double()) for a, b in v] for k, v in w.items()}


@pytest.mark.parametrize("adapter,ref,cfg", CASES)
def test_loss_and_gradient_match_the_program_in_float64(adapter, ref, cfg):
    """The program's phase loss on float64 banks (eager jets) against the
    reference: loss and every gradient leaf within 1e-10."""
    from pinn_elastodynamics_torch.banks import make_bank
    from pinn_elastodynamics_torch.cases.base import _phase_loss_fn
    from pinn_elastodynamics_torch.train.step import value_and_grad

    seed = 77
    host = adapter.banks(cfg, seed)
    case = _program_case(adapter, cfg, seed)
    case.banks = {k: make_bank(v["xyt"], {n: a for n, a in v.items()
                                          if n != "xyt"},
                               dtype=torch.float64, pad_to_multiple_of=8,
                               device="cpu")
                  for k, v in host.items()}
    w64 = _weights64(cfg, seed)
    params = {k: wt.program_tree(v) for k, v in w64.items()}
    if adapter is wave_confined:
        params = params["net"]
    sub_fn, sub0, _ = _phase_loss_fn(case, case.phases[-1], params)
    loss, grads = value_and_grad(sub_fn, sub0)
    x = _flat(w64[adapter.TRAINABLE]).numpy()
    f, g = reference_value_grad(adapter, ref, w64, host, x, CPU, True)
    assert abs(float(loss) - f) <= 1e-10 * abs(f)
    g_prog = torch.cat([t.reshape(-1) for layer in grads
                        for t in (layer["W"], layer["b"])]).numpy()
    np.testing.assert_allclose(g_prog, g, rtol=0, atol=1e-10 * np.abs(g).max())


@pytest.mark.parametrize("adapter,ref,cfg", CASES)
def test_benchmark_float32_path_matches_the_reference(adapter, ref, cfg):
    """What the benchmark times (the adapter's float32 banks and weights)
    against the float64 reference, within float32 rounding."""
    from pinn_elastodynamics_torch.train.step import value_and_grad

    seed = 91
    host = adapter.banks(cfg, seed)
    w = wt.make(cfg["nets"], seed, CPU)
    sub_fn, sub0 = adapter.program(cfg, host, w, CPU)
    loss, _ = value_and_grad(sub_fn, sub0)
    w64 = {k: [(a.double(), b.double()) for a, b in v] for k, v in w.items()}
    f, _ = reference_value_grad(adapter, ref, w64, host,
                                _flat(w64[adapter.TRAINABLE]).numpy(), CPU,
                                False)
    assert abs(float(loss) - f) <= 1e-5 * abs(f)


def test_served_fields_match_the_program():
    from pinn_elastodynamics_torch.cases import plate_hole
    from pinn_elastodynamics_torch.eval.render import predict_fields

    seed = 5
    w64 = _weights64(PLATE, seed)
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.5, (300, 2))
    t = 2.5
    model = plate_hole.build_model(jet_impl="eager")
    params = {k: wt.program_tree(v) for k, v in w64.items()}
    got = predict_fields(model, params, xy, t, chunk=128, dtype=np.float64,
                         device="cpu")
    xyt = np.concatenate([xy, np.full((300, 1), t)], axis=1)
    want = ref_plate.fields(w64, xyt, "float64", CPU)
    for k in ref_plate.FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -12,
                      3.0], dtype=torch.float32)
    got = mlp.tf32_round(x)
    # ties go to even; below half an ulp of 2^-10 goes down
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -9, -1.0, 3.0]


def test_composite_jet_matches_autograd():
    """The reference's jet against nested autograd of the plain forward."""
    seed = 3
    w64 = _weights64(PLATE, seed)
    x = torch.rand(16, 3, dtype=torch.float64)
    j = mlp.composite_jet(w64, x, 2, "float64")
    for r in range(16):
        p = x[r].clone().requires_grad_()
        f = mlp.composite_forward(w64, p[None], "float64")[0]
        for c in range(5):
            (d,) = torch.autograd.grad(f[c], p, create_graph=True)
            (dtt,) = torch.autograd.grad(d[2], p, retain_graph=True)
            for i in range(3):
                assert abs(float(d[i].detach()) - float(j.d[i][r, c])) < 1e-12
            assert abs(float(dtt[2]) - float(j.tt[r, c])) < 1e-11
