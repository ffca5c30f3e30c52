"""PyTorch port: the fused-jet entry points' forward on CPU tensors against
the JAX Pallas kernels in interpret mode (f32), plus the launchers' checks.

On a CPU tensor each launcher runs its plain version; the CUDA kernels
themselves are held to the same plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_elastodynamics_tpu.kernels import fused_jet as jfj
from pinn_elastodynamics_torch.kernels import _native
from pinn_elastodynamics_torch.kernels import fused_jet as tfj
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as tvjp

ATOL = 2e-6  # tests/test_pallas_kernel.py's forward tolerance
LB, UB = (0.0, 0.0, 0.0), (0.5, 0.5, 10.0)


def _mlp_params(rng, dims):
    return [{"W": (rng.standard_normal((i, o)) * np.sqrt(2.0 / (i + o))
                   ).astype(np.float32),
             "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
            for i, o in zip(dims[:-1], dims[1:])]


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree, jnp.float32)


def _points(rng, n=333):
    return np.concatenate([rng.uniform(0, 0.5, (n, 2)),
                           rng.uniform(0, 10, (n, 1))], 1).astype(np.float32)


def _assert_jet(tj, jj, atol=ATOL):
    assert tj.f.dtype == torch.float32
    np.testing.assert_allclose(tj.f.numpy(), np.asarray(jj.f), rtol=0, atol=atol)
    np.testing.assert_allclose(tj.d.numpy(), np.asarray(jj.d), rtol=0, atol=atol)
    if jj.dtt is None:
        assert tj.dtt is None
    else:
        np.testing.assert_allclose(tj.dtt.numpy(), np.asarray(jj.dtt),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("order", [1, 2])
def test_fused_seed_jet_matches_pallas(order):
    rng = np.random.default_rng(10)
    params = _mlp_params(rng, [16, 70, 70, 5])
    n = 333
    h0 = rng.uniform(-1, 1, (n, 16)).astype(np.float32)
    d = rng.standard_normal((3, n, 16)).astype(np.float32)
    dtt = rng.standard_normal((n, 16)).astype(np.float32) if order == 2 else None
    want = jfj.fused_seed_jet(_jax(params), _jax(h0), _jax(d),
                              None if dtt is None else _jax(dtt),
                              block=128, interpret=True)
    tdtt = None if dtt is None else _torch(dtt)
    got = tvjp.fused_seed_jet_vjp(_torch(params), _torch(h0), _torch(d), tdtt)
    _assert_jet(got, want)
    ref = tfj.fused_seed_jet_reference(_torch(params), _torch(h0), _torch(d), tdtt)
    _assert_jet(ref, want)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_fused_jet_matches_pallas(order, norm):
    rng = np.random.default_rng(11)
    params = _mlp_params(rng, [3, 70, 70, 5])
    x = _points(rng)
    kw = dict(lb=LB, ub=UB) if norm else {}
    want = jfj.fused_jet(_jax(params), _jax(x), order=order, block=128,
                         interpret=True, **kw)
    got = tvjp.fused_jet_vjp(_torch(params), _torch(x), order=order, **kw)
    _assert_jet(got, want)
    _assert_jet(tfj.fused_jet_reference(_torch(params), _torch(x), order=order,
                                        **kw), want)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_fused_composite_jet_matches_pallas(order, norm):
    rng = np.random.default_rng(12)
    params = {"uv": _mlp_params(rng, [3, 70, 70, 5]),
              "dist": _mlp_params(rng, [3, 20, 20, 5]),
              "part": _mlp_params(rng, [3, 20, 20, 5])}
    x = _points(rng)
    kw = dict(lb=LB, ub=UB) if norm else {}
    want = jfj.fused_composite_jet(_jax(params), _jax(x), order=order,
                                   block=128, interpret=True, **kw)
    got = tvjp.fused_composite_jet_vjp(_torch(params), _torch(x), order=order,
                                       **kw)
    _assert_jet(got, want)
    _assert_jet(tfj.fused_composite_jet_reference(_torch(params), _torch(x),
                                                  order=order, **kw), want)


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(13)
    params = _torch(_mlp_params(rng, [3, 8, 5]))
    x = _torch(_points(rng, 10))
    tfj.reset_launches()
    tvjp.fused_jet_vjp(params, x, order=2)
    tvjp.fused_composite_jet_vjp(
        {"uv": params, "dist": params, "part": params}, x)
    assert tfj.LAUNCHES == {"fused_mlp_jet": 0, "fused_composite_jet": 0}


def test_wrappers_reject_bad_arguments():
    rng = np.random.default_rng(14)
    params = _torch(_mlp_params(rng, [3, 8, 5]))
    x = _torch(_points(rng, 10))
    with pytest.raises(ValueError, match="order"):
        tvjp.fused_jet_vjp(params, x, order=3)
    with pytest.raises(ValueError, match="lb and ub"):
        tvjp.fused_composite_jet_vjp(
            {"uv": params, "dist": params, "part": params}, x, lb=LB)
    with pytest.raises(ValueError, match=r"\(N, A\)"):
        tvjp.fused_jet_vjp(params, x[0])
    with pytest.raises(ValueError, match="seed shapes"):
        tvjp.fused_seed_jet_vjp(params, x, torch.zeros(3, 9, 3))
    with pytest.raises(ValueError, match="dtt"):
        tvjp.fused_seed_jet_vjp(params, x, torch.zeros(3, 10, 3),
                                torch.zeros(10, 2))
    with pytest.raises(ValueError, match="device"):
        tvjp.fused_jet_vjp(params, x.to("meta"))


def test_native_build_names_and_errors(monkeypatch):
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert path.name.startswith("libfused_jet_") and path.suffix == ".so"
    assert _native.library_path() == path  # stable for one source
    assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(_native, "NVCC_DEFAULT", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native._nvcc()


def test_pack_params_layout_matches_kernel_contract():
    """Per layer: W row-major, then b; dims chain fan_in -> fan_out."""
    rng = np.random.default_rng(15)
    params = _torch(_mlp_params(rng, [3, 4, 2]))
    packed, dims = tfj.pack_params(params, torch.device("cpu"))
    assert dims == [3, 4, 2]
    want = torch.cat([params[0]["W"].reshape(-1), params[0]["b"],
                      params[1]["W"].reshape(-1), params[1]["b"]])
    torch.testing.assert_close(packed, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="layers"):
        tfj.pack_params(params * 9, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not chain"):
        tfj.pack_params(params[::-1], torch.device("cpu"))
    with pytest.raises(TypeError, match="float32"):
        tfj.pack_params([{k: v.double() for k, v in p.items()} for p in params],
                        torch.device("cpu"))
