"""PyTorch port: the benchmark entry point (``pinn_elastodynamics_torch/
bench.py``) on the CPU.

The FLOP count from the shapes is held to XLA's ``cost_analysis`` of the
same value+grad in the JAX package; every measuring function runs at scale
0.01 with one or two iterations; the seconds-to-target path from JAX's
parameters in float64 is held to the JAX package's ``run_pipeline`` and
``minimize(target=...)`` at the same budgets; ``main`` prints one JSON
line, refuses to run without a card unless asked for the CPU, and its
correctness check catches a composite forward off by 1e-4.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_torch import bench
from pinn_elastodynamics_torch.kernels import fused_jet as tfj
from pinn_elastodynamics_torch.train.checkpoint import params_from_jax
from pinn_elastodynamics_tpu.cases import base as jbase
from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.train.lbfgs import minimize as jminimize
from pinn_elastodynamics_tpu.train.step import make_loss_fn as jmake_loss_fn

SCALE = 0.01
FLOPS_REL = 0.10   # the count from the shapes against XLA's
REL = 1e-8         # float64 losses, as tests/test_torch_pipeline.py
PRETRAIN = 3
MAXITER = 10
FWD_POINTS = 256
# The keys of bench.py's line that the port's line keeps, and its own.
KEYS = {
    "metric", "value", "unit", "vs_baseline", "n_collocation",
    "step_seconds", "flops_per_step", "flops_per_eval", "tflops_sustained",
    "mfu", "uv_phase_evals_per_sec", "composite_fwd_evals_per_sec",
    "composite_fused_speedup", "lbfgs_iters_per_sec",
    "lbfgs_iters_per_sec_cold", "lbfgs_iters_measured", "cpu_evals_per_sec",
    "host_load_start", "host_busy", *bench.STT_KEYS, "device", "correct",
    "mfu_peak_tflops_f32", "launches", "check",
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    return bench.build(SCALE, device="cpu")


def _positive(*values):
    for v in values:
        assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, v


@pytest.mark.parametrize("scale", [0.01, 0.05])
def test_flops_per_step_matches_xla(scale):
    """The count from the shapes (FLOPs of the jets' value+grad, nothing for
    elementwise work) within 10% of XLA's count of the whole value+grad."""
    jcase = jplate.build(scale=scale, pad_to_multiple_of=bench.PAD,
                         jet_impl="xla")
    loss_fn = jmake_loss_fn(jcase.model, jcase.loss, jcase.material)
    vg = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b)[0]))
    cost = vg.lower(jcase.init_params(seed=0), jcase.banks).compile()
    cost = cost.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = float(cost["flops"])
    case, _, _, _ = bench.build(scale, device="cpu")
    ours = bench.flops_per_step(case)
    assert abs(ours - xla) <= FLOPS_REL * xla, (ours, xla)


def test_build_counts_real_collocation_points(built):
    case, _, params, n_col = built
    bank = case.banks["collocation"]
    assert bank.n_total % bench.PAD == 0 and 0 < n_col <= bank.n_total
    assert n_col == int(np.count_nonzero(bank.mask.numpy()))
    assert params["uv"][0]["W"].dtype == torch.float32


def _measure(name, built):
    case, scalar_loss, params, n_col = built
    if name == "rate_blocked":
        return bench.rate_blocked(scalar_loss, params, case.banks, n_col, 2)
    if name == "uv_phase_rate":
        return (bench.uv_phase_rate(case, params, n_col, iters=1),)
    if name == "composite_forward_rate":
        return bench.composite_forward_rate(case, params, iters=2,
                                            n=FWD_POINTS)
    if name == "lbfgs_iter_rate":
        rate, iters, cold = bench.lbfgs_iter_rate(case, params, 2)
        assert iters == 2
        return rate, iters, cold
    if name == "cpu_rate":
        return (bench.cpu_rate(SCALE, 1),)
    out = bench.seconds_to_target(SCALE, 10.0, MAXITER, repeats=1,
                                  pretrain_iters=PRETRAIN, device="cpu")
    assert set(out) == set(bench.STT_KEYS)
    assert 1 <= out["target_iters"] <= MAXITER
    assert out["target_hit"] == (out["target_final_loss"] <= 10.0)
    return (out["seconds_to_target"], *out["seconds_to_target_spread"],
            out["target_final_loss"], out["seconds_to_target_cpu"],
            out["speedup_to_target"])


@pytest.mark.parametrize("name", [
    "rate_blocked", "uv_phase_rate", "composite_forward_rate",
    "lbfgs_iter_rate", "cpu_rate", "seconds_to_target"])
def test_measurement_runs_on_cpu(name, built):
    """Each measuring function at scale 0.01 with 1-2 iterations returns
    finite positive numbers."""
    _positive(*_measure(name, built))


def test_seconds_to_target_matches_jax():
    """From JAX's seed-0 parameters in float64: 3 pretraining iterations of
    dist and of part, then the uv phase to a threshold between the 6th and
    7th losses of the JAX warm-up run; the same iterations (7) and the final
    loss within 1e-8 relative."""
    jcase = jplate.build(scale=SCALE, pad_to_multiple_of=bench.PAD,
                         dtype=np.float64, jet_impl="xla")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           jcase.init_params(seed=0))
    host = jax.tree.map(np.asarray, jparams)
    jp, _ = jbase.run_pipeline(
        jcase, jparams, dtype=jnp.float64,
        maxiter_override={"dist": PRETRAIN, "part": PRETRAIN, "uv": 0},
        segment=50)
    sub_fn, sub0, _ = jbase._phase_loss_fn(jcase, jcase.phases[-1], jp)
    hist = np.asarray(jminimize(sub_fn, sub0, maxiter=MAXITER,
                                segment=MAXITER).loss_history)
    assert hist[6] < hist[5], hist
    threshold = float(0.5 * (hist[5] + hist[6]))
    jres = jminimize(sub_fn, sub0, maxiter=MAXITER, segment=MAXITER,
                     target=threshold)
    assert jres.n_iters == 7

    out = bench.seconds_to_target(
        SCALE, threshold, MAXITER, repeats=1, pretrain_iters=PRETRAIN,
        with_cpu=False, device="cpu", dtype=torch.float64,
        params=params_from_jax(host, device="cpu", dtype=torch.float64))
    assert out["target_iters"] == jres.n_iters
    assert out["target_hit"] is True
    want = float(jres.final_loss)
    assert abs(out["target_final_loss"] - want) <= REL * abs(want)


def _tiny_main(capsys, monkeypatch, *extra):
    monkeypatch.setattr(bench, "FWD_POINTS", FWD_POINTS)
    line = bench.main(["--device", "cpu", "--scale", "0.002",
                       "--blocked-iters", "1", "--lbfgs-iters", "2",
                       "--cpu-scale", "1", "--cpu-iters", "1",
                       "--stt-scale", "0.002", "--stt-maxiter", "2", *extra])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    assert json.loads(printed[0]) == line
    return line


def test_main_prints_one_json_line(capsys, monkeypatch):
    line = _tiny_main(capsys, monkeypatch)
    assert set(line) == KEYS
    assert line["metric"] == "collocation_evals_per_sec"
    assert line["unit"] == "evals/s" and line["correct"] is True
    assert line["device"]["type"] == "cpu" and line["device"]["name"] == "cpu"
    # No card: no peak and no MFU, never a CPU number under a card's name.
    assert line["mfu"] is None and line["mfu_peak_tflops_f32"] is None
    _positive(line["value"], line["vs_baseline"], line["step_seconds"],
              line["flops_per_step"], line["uv_phase_evals_per_sec"],
              line["composite_fwd_evals_per_sec"],
              line["lbfgs_iters_per_sec"], line["lbfgs_iters_per_sec_cold"],
              line["cpu_evals_per_sec"], line["seconds_to_target"])
    assert line["lbfgs_iters_measured"] == 2
    assert line["launches"] == {
        **bench.expected_launches("cpu"),
        "measurements": bench.expected_launches("cpu")["full_value_and_grad"]}


def test_main_skips_read_null(capsys, monkeypatch):
    line = _tiny_main(capsys, monkeypatch, "--skip-cpu", "--skip-lbfgs",
                      "--skip-stt")
    assert set(line) == KEYS
    for key in ("vs_baseline", "cpu_evals_per_sec", "lbfgs_iters_per_sec",
                "lbfgs_iters_per_sec_cold", "lbfgs_iters_measured",
                *bench.STT_KEYS):
        assert line[key] is None, key


def test_main_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main([])


def test_check_catches_scaled_composite_forward(built, monkeypatch):
    """A one-launch forward scaled by 1 + 1e-4 fails the check; the
    unchanged one passes it."""
    case, scalar_loss, params, _ = built
    bench.check_outputs(case, scalar_loss, params, n=FWD_POINTS)
    plain = tfj.fused_composite_jet_stack
    monkeypatch.setattr(tfj, "fused_composite_jet_stack",
                        lambda *a, **k: plain(*a, **k) * (1 + 1e-4))
    with pytest.raises(AssertionError, match="one-launch composite forward"):
        bench.check_outputs(case, scalar_loss, params, n=FWD_POINTS)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 67.0), ("NVIDIA H100 PCIe", None),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_only_for_a_known_card(monkeypatch, name, peak):
    """The float32 peak of the SXM H100, None for another card and for the
    CPU (no card is touched: the name is patched in)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert bench.peak_tflops("cuda") == peak
    assert bench.peak_tflops("cpu") is None
