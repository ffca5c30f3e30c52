"""Neither the benchmark nor the program it drives loads JAX or the JAX
package, and the reference loads nothing of the program."""

import json
import subprocess
import sys

from benchmark import core
from benchmark.run import ROOT

MODULES = ("benchmark.run", "benchmark.study", "benchmark.drivers.train",
           "benchmark.drivers.serve", "benchmark.adapters.plate_netbc",
           "benchmark.adapters.wave_confined",
           "pinn_elastodynamics_torch.cases.plate_hole",
           "pinn_elastodynamics_torch.cases.wave_confined",
           "pinn_elastodynamics_torch.serving",
           "pinn_elastodynamics_torch.train.lbfgs",
           "pinn_elastodynamics_torch.kernels.fused_jet_vjp")


def _loaded(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_no_jax_in_the_benchmarks_process():
    assert not _loaded(MODULES) & set(core.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    refs = ("benchmark.reference.mlp", "benchmark.reference.plate_netbc",
            "benchmark.reference.wave_confined", "benchmark.reference.lbfgs",
            "benchmark.reference.compare")
    assert "pinn_elastodynamics_torch" not in _loaded(refs)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pinn_elastodynamics_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert core.forbidden_loaded() == ["jax"]
