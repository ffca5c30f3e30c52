"""PyTorch port: Adam, the training step, initialisation, checkpoints and
tree paths, against the JAX package (f64 on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.cases import plate_hole as jplate
from pinn_elastodynamics_tpu.models import analytic_bc as janalytic
from pinn_elastodynamics_tpu.models import fields as jfields
from pinn_elastodynamics_tpu.train import adam as jadam
from pinn_elastodynamics_tpu.train import checkpoint as jckpt
from pinn_elastodynamics_tpu.utils import treepath as jtreepath
from pinn_elastodynamics_torch.cases import plate_hole as tplate
from pinn_elastodynamics_torch.models import analytic_bc as tanalytic
from pinn_elastodynamics_torch.models import fields as tfields
from pinn_elastodynamics_torch.models import fourier as tfourier
from pinn_elastodynamics_torch.models import mlp as tmlp
from pinn_elastodynamics_torch.train import adam as tadam
from pinn_elastodynamics_torch.train import checkpoint as tckpt
from pinn_elastodynamics_torch.train.step import make_grad_step
from pinn_elastodynamics_torch.utils import treepath as ttreepath
from pinn_elastodynamics_torch.utils.tree import tree_leaves

F64 = torch.float64
CPU = "cpu"
REL = 1e-10
LR = 1e-3


def _small_plate_cases():
    """The analytic-BC plate at scale 0.02 with a 3→16→16→5 uv net, in both
    packages, and numpy-seeded parameters."""
    jspec = jfields.FieldSpec(ndim=2, formulation=jfields.SECOND_ORDER)
    tspec = tfields.FieldSpec(ndim=2, formulation=tfields.SECOND_ORDER)
    jcase = jplate.build(scale=0.02, dtype=np.float64, bc="analytic")
    tcase = tplate.build(scale=0.02, dtype=F64, device="cpu", bc="analytic")
    jcase.model = janalytic.AnalyticCompositeFieldModel(
        spec=jspec, uv_model=jfields.MLPFieldModel(spec=jspec, hidden=(16, 16)),
        dist_fn=jplate.analytic_dist, part_fn=jplate.analytic_part)
    tcase.model = tanalytic.AnalyticCompositeFieldModel(
        spec=tspec, uv_model=tfields.MLPFieldModel(spec=tspec, hidden=(16, 16)),
        dist_fn=tplate.analytic_dist, part_fn=tplate.analytic_part)
    rng = np.random.default_rng(7)
    dims = [3, 16, 16, 5]
    host = {"uv": [{"W": rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o)),
                    "b": 0.1 * rng.standard_normal(o)}
                   for i, o in zip(dims[:-1], dims[1:])]}
    return jcase, tcase, host


@pytest.fixture(scope="module")
def plate():
    return _small_plate_cases()


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1e-300, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_run_adam_matches_jax_and_resumes(plate):
    jcase, tcase, host = plate
    jfn, tfn = jcase.loss_and_aux_fn(), tcase.loss_and_aux_fn()
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), host)
    tp = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    j1 = jadam.run_adam(jfn, jp, LR, iters=5)
    t1 = tadam.run_adam(tfn, tp, LR, iters=5)
    j2 = jadam.run_adam(jfn, j1.params, LR, iters=5, opt_state=j1.opt_state)
    t2 = tadam.run_adam(tfn, t1.params, LR, iters=5, opt_state=t1.opt_state)
    for jr, tr in ((j1, t1), (j2, t2)):
        assert sorted(tr.history) == sorted(jr.history)
        for k in jr.history:
            assert tr.history[k].shape == (5,)
            _close(tr.history[k], jr.history[k])
        for a, b in zip(tree_leaves(tr.params), jax.tree.leaves(jr.params)):
            _close(a, b)
    assert t2.opt_state["count"] == 10
    assert t2.history["loss"][-1] < t1.history["loss"][0]
    # The resumed run continues the uninterrupted one exactly.
    t10 = tadam.run_adam(tfn, tp, LR, iters=10)
    np.testing.assert_array_equal(t10.history["loss"][5:], t2.history["loss"])


def test_grad_step_is_one_adam_step(plate):
    _, tcase, host = plate
    tp = tckpt.params_from_jax(host, device="cpu", dtype=F64)
    step = make_grad_step(tcase.model, tcase.loss, tcase.material,
                          tadam.Adam(LR))
    state = tadam.Adam(LR).init(tp)
    params, losses = tp, []
    for _ in range(2):
        params, state, loss, comps = step(params, state, tcase.banks)
        losses.append(float(loss))
        assert sorted(comps) == ["HOLE", "f_s", "f_uv"]
    ref = tadam.run_adam(tcase.loss_and_aux_fn(), tp, LR, iters=2)
    np.testing.assert_array_equal(losses, ref.history["loss"])
    for a, b in zip(tree_leaves(params), tree_leaves(ref.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_xavier_init_stats():
    """Truncated-normal Xavier: zero mean, stddev ≈ 0.88·sqrt(2/(fan_in +
    fan_out)) after the ±2σ truncation, support within ±2σ — the checks of
    tests/test_jet_mlp.py::test_xavier_init_stats."""
    w = tmlp.truncated_normal_xavier(torch.Generator().manual_seed(0),
                                     (400, 300), F64, "cpu")
    std = float(np.sqrt(2.0 / 700.0))
    assert abs(float(w.mean())) < 0.001
    assert abs(float(w.std()) - std * 0.88) < 0.01
    assert float(w.abs().max()) <= 2.0 * std + 1e-12


def test_model_init_layouts_and_seeding():
    spec = tfields.FieldSpec(ndim=2, formulation=tfields.SECOND_ORDER)
    gen = lambda s: torch.Generator().manual_seed(s)
    params = tmlp.init_mlp(gen(0), [3, 20, 30, 5], torch.float32, "cpu")
    assert [tuple(l["W"].shape) for l in params] == [(3, 20), (20, 30), (30, 5)]
    assert all(float(l["b"].abs().max()) == 0.0 for l in params)
    composite = tplate.build_model(jet_impl="eager")
    a = composite.init(gen(3), device=CPU)
    b = composite.init(gen(3), device=CPU)
    assert sorted(a) == ["dist", "part", "uv"]
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a["uv"][0]["W"],
                           composite.init(gen(4), device=CPU)["uv"][0]["W"])
    fourier = tfourier.FourierMLPFieldModel(spec=spec, hidden=(8,),
                                            n_features=500, feature_scale=2.0)
    p = fourier.init(gen(5), F64, CPU)
    assert p["B"].shape == (3, 500)
    assert abs(float(p["B"].std()) - 2.0) < 0.1
    analytic = tplate.build_model(bc="analytic", fourier=64)
    assert tmlp.mlp_layers(analytic.init(gen(6), device=CPU)["uv"]["mlp"]) == [
        128] + [70] * 8 + [5]


@pytest.mark.parametrize("init", [
    lambda gen: tplate.build_model().init(gen),
    lambda gen: tplate.build_model(bc="analytic", fourier=8).init(gen),
    lambda gen: tmlp.init_mlp(gen, [3, 4, 5]),
], ids=["net_bc", "analytic_fourier", "mlp"])
def test_model_init_defaults_to_gpu(init):
    """Like ``plate_hole.build``, ``init`` places parameters on the GPU
    unless the CPU is asked for; without a GPU that raises rather than
    carrying on quietly on the CPU."""
    gen = torch.Generator().manual_seed(7)
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in tree_leaves(init(gen)))
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            init(gen)


def test_save_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "state.ckpt")
    params = tplate.build_model().init(torch.Generator().manual_seed(1),
                                       device=CPU)
    state = tadam.Adam(LR).init(params)
    tckpt.save_checkpoint(path, {"params": params, "opt_state": state,
                                 "phase": "uv", "iters": np.int32(7)})
    assert os.listdir(tmp_path / "sub") == ["state.ckpt"]   # no temp left
    host = tckpt.load_checkpoint(path)
    jtree = jckpt.load_checkpoint(path)                     # JAX reads it
    assert host["phase"] == "uv" and int(jtree["iters"]) == 7
    assert host["opt_state"]["count"] == 0
    for a, b, c in zip(tree_leaves(params), tree_leaves(host["params"]),
                       jax.tree.leaves(jtree["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(b, np.asarray(c))
    back = tckpt.params_from_jax(host["params"], device="cpu")
    tckpt.assert_layers_match(back["uv"], [3] + [70] * 8 + [5])
    with pytest.raises(AssertionError, match="layers"):
        tckpt.assert_layers_match(back["dist"], [3, 20, 5])

    class Boom:
        def __reduce__(self):
            raise RuntimeError("cannot pickle")

    with pytest.raises(RuntimeError, match="cannot pickle"):
        tckpt.save_checkpoint(path, {"bad": Boom()})
    assert os.listdir(tmp_path / "sub") == ["state.ckpt"]
    assert tckpt.load_checkpoint(path)["phase"] == "uv"      # old file kept


def test_treepath_matches_jax():
    tree = {"uv": {"B": 1, "mlp": [2, 3]}, "dist": 4}
    for path in ("uv", "uv.mlp", "uv.B", "dist"):
        assert ttreepath.path_get(tree, path) == jtreepath.path_get(tree, path)
        got = ttreepath.path_set(tree, path, "x")
        assert got == jtreepath.path_set(tree, path, "x")
        assert ttreepath.path_get(got, path) == "x"
    got = ttreepath.path_set(tree, "uv.mlp", [9])
    assert got["uv"]["B"] == 1 and tree["uv"]["mlp"] == [2, 3]
    assert got["dist"] is tree["dist"]


@pytest.mark.parametrize("has_aux", [False, True])
def test_value_and_grad_zeros_for_unreached_leaf(has_aux):
    """A leaf the loss never reaches gets zeros of its shape and dtype, as
    from ``jax.value_and_grad``; the reached leaves' gradients agree."""
    from pinn_elastodynamics_torch.train.step import value_and_grad

    rng = np.random.default_rng(41)
    tree = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5),
            "c": [rng.standard_normal(2)]}

    def jfn(q):
        loss = (q["a"] ** 2).sum() + jnp.sin(q["c"][0]).sum()
        return (loss, {"half": 0.5 * loss}) if has_aux else loss

    def tfn(q):
        loss = (q["a"] ** 2).sum() + torch.sin(q["c"][0]).sum()
        return (loss, {"half": 0.5 * loss}) if has_aux else loss

    jout, jgrads = jax.value_and_grad(jfn, has_aux=has_aux)(
        jax.tree.map(jnp.asarray, tree))
    tparams = {"a": torch.as_tensor(tree["a"]), "b": torch.as_tensor(tree["b"]),
               "c": [torch.as_tensor(tree["c"][0])]}
    tout, tgrads = value_and_grad(tfn, tparams, has_aux=has_aux)
    if has_aux:
        (jloss, jaux), (tloss, taux) = jout, tout
        assert float(taux["half"]) == pytest.approx(float(jaux["half"]),
                                                    rel=REL)
    else:
        jloss, tloss = jout, tout
    assert float(tloss) == pytest.approx(float(jloss), rel=REL)
    assert tgrads["b"].dtype == F64 and tgrads["b"].shape == (5,)
    assert torch.equal(tgrads["b"], torch.zeros(5, dtype=F64))
    for jl, tl in zip(jax.tree.leaves(jgrads), tree_leaves(tgrads)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=REL,
                                   atol=0)
