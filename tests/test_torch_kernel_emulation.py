"""PyTorch port: the CUDA sources of the fused-jet kernels, compiled for the
CPU and run one thread per block, against their plain PyTorch versions.

There is no CUDA compiler here, so the kernels themselves run only on the
card (chip_smoke.py).  But every phase of these kernels between two
``__syncthreads`` is a loop strided by the block's thread count, so with
``blockDim.x = 1`` one thread does all of a phase's work in order, and the
blocks can run one after the other: that is a faithful sequential execution
of the same source.  A stub ``cuda_runtime.h`` maps the CUDA keywords to
C++, the launches ``kernel<<<cfg>>>(args)`` become a loop over blocks, and
g++ builds the result into a shared library driven through the same ctypes
signatures as the real one.  It checks the kernels' indexing, layouts,
reductions and ragged tiles, not their behaviour under real concurrency.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pinn_elastodynamics_torch.kernels import _native
from pinn_elastodynamics_torch.kernels import fused_jet as tfj
from pinn_elastodynamics_torch.kernels import fused_jet_vjp as tvjp
from pinn_elastodynamics_torch.kernels.fused_jet import (
    _float_array,
    _int_array,
    pack_params,
)
from pinn_elastodynamics_torch.models.mlp import seed_jet
from pinn_elastodynamics_torch.utils.tree import tree_leaves

TOL = 2e-4  # f32 against the f64 plain version: tests/test_fused_vjp.py
CPU = torch.device("cpu")

STUB = r"""
#pragma once
#include <math.h>
#include <cstddef>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(a, b)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3v { unsigned x, y, z; };
inline dim3v threadIdx, blockIdx, blockDim, gridDim;
inline float4 emu_smem[232448 / 16];
inline void __syncthreads() {}
inline int min(int a, int b) { return a < b ? a : b; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// One thread runs every phase in order, so an asynchronous copy may land at
// once and the waits have nothing to wait for.
inline void copy_async4(float* dst, const float* src) { *dst = *src; }
inline void copy_async16(float* dst, const float* src) { memcpy(dst, src, 16); }
inline void copy_async_commit() {}
inline void copy_async_wait() {}
inline void copy_async_wait_prior() {}
inline float4 load_cg(const float4* p) { return *p; }
template <class K, class... A>
void emu_launch(int grid, int, size_t bytes, cudaStream_t, K k, A... args) {
  memset(emu_smem, 0xff, bytes);  // no stale zeros: shared memory is garbage
  gridDim.x = grid;
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    k(args...);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """Both CUDA sources, emulated, in one library like the real build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    tmp = tmp_path_factory.mktemp("emulation")
    (tmp / "cuda_runtime.h").write_text(STUB)
    for header in _native.HEADERS:
        shutil.copy(header, tmp / header.name)
    cpps = []
    for source in _native.SOURCES:
        src = re.sub(r"(\w+(?:<S, DTT>)?)\s*<<<([^>]*)>>>\(",
                     r"emu_launch(\2, \1, ", source.read_text())
        src = src.replace("extern __shared__ float4 smem4[];",
                          "float4* smem4 = emu_smem;")
        cpp = tmp / f"{source.stem}.cpp"
        cpp.write_text(src)
        cpps.append(str(cpp))
    out_lib = tmp / "libfused_jet_emulated.so"
    out = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-Wno-unknown-pragmas",
         "-I", str(tmp), "-o", str(out_lib), *cpps],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return _native.bind(out_lib)


def _mlp(rng, dims):
    return [{"W": torch.as_tensor(rng.standard_normal((i, o))
                                  * np.sqrt(2.0 / (i + o)), dtype=torch.float32),
             "b": torch.as_tensor(0.1 * rng.standard_normal(o),
                                  dtype=torch.float32)}
            for i, o in zip(dims[:-1], dims[1:])]


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f64(v) for v in tree]
    return tree.double()


def _close(got, want):
    scale = max(1.0, float(want.abs().max()))
    assert float((got.double() - want).abs().max()) <= TOL * scale


def _points(rng, n, a):
    return torch.as_tensor(np.concatenate(
        [rng.uniform(0, 0.5, (n, a - 1)), rng.uniform(0, 10, (n, 1))], 1),
        dtype=torch.float32)


def _mlp_bwd(lib, params, h0, d, dtt, cot, full_dx, max_blocks):
    packed, dims = pack_params(params, CPU)
    n, e = h0.shape
    s = cot.shape[0]
    order = 2 if dtt is not None else 1
    per_block = lib.fused_mlp_jet_bwd_workspace(d.shape[0], order,
                                                _int_array(dims), len(params))
    assert per_block >= 0
    partial = torch.empty(max_blocks, packed.numel())
    workspace = torch.full((max(1, max_blocks * per_block),), float("nan"))
    grad = torch.empty_like(packed)
    dseed = torch.empty((s, n, e) if full_dx else (n, e))
    err = lib.fused_mlp_jet_bwd_launch(
        h0.data_ptr(), d.data_ptr(), None if dtt is None else dtt.data_ptr(),
        cot.data_ptr(), n, d.shape[0], order,
        packed.data_ptr(), _int_array(dims), len(params), int(full_dx),
        max_blocks, partial.data_ptr(), grad.data_ptr(), dseed.data_ptr(),
        workspace.data_ptr(), None)
    assert err == 0
    tvjp.count_body(lib, d.shape[0], order, dims)
    return tvjp._unpack_grads(grad, dims), dseed


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("a", [3, 4])
def test_emulated_mlp_backward_matches_plain(lib, a, order):
    """B2 (value-row seed cotangent) and B3b (full seed cotangent), ragged
    tiles, one and several blocks, and a Fourier-width seed."""
    rng = np.random.default_rng(10 * a + order)
    s = 1 + a + order - 1
    for n, e, full_dx, max_blocks in ((37, a, False, 3), (64, 12, True, 1),
                                      (5, 128, True, 4)):
        params = _mlp(rng, [e, 16, 9, 5])
        h0 = torch.as_tensor(rng.uniform(-1, 1, (n, e)), dtype=torch.float32)
        d = torch.as_tensor(rng.standard_normal((a, n, e)), dtype=torch.float32)
        dtt = (torch.as_tensor(rng.standard_normal((n, e)), dtype=torch.float32)
               if order == 2 else None)
        cot = torch.as_tensor(rng.standard_normal((s, n, 5)),
                              dtype=torch.float32)
        grads, dseed = _mlp_bwd(lib, params, h0, d, dtt, cot,
                                full_dx, max_blocks)
        want, want_seed = tvjp.mlp_jet_bwd_reference(
            _f64(params), h0.double(), d.double(),
            None if dtt is None else dtt.double(), cot.double())
        for g, w in zip(tree_leaves(grads), tree_leaves(want)):
            _close(g, w)
        _close(dseed, want_seed if full_dx else want_seed[0])
        again = _mlp_bwd(lib, params, h0, d, dtt, cot,
                         full_dx, max_blocks)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(again), tree_leaves((grads, dseed))))


# (a, order, widths, n, full_dx, max_blocks): the plate nets of B2 and B3b,
# the wave-confined net (W1) and its Fourier form (a 16-point tile with one
# weight buffer), the order-1 wave nets 80 x 8 and 100 x 8 of B2, the
# inverse problem's 140-wide net at order 2 (its acceleration sensors), a 3D
# order-2 net, the two 3D nets of cases/elastic3d.py (order 1, twelve
# outputs), nets of 1, 2 and 4 layers (every rotation of the row buffers),
# and a two-layer net wide enough for one weight buffer at 8 points; ragged
# n, several tiles per block and several blocks.
WIDE_CASES = {
    "b2_plate": (3, 2, [3] + [70] * 8 + [5], 77, False, 2),
    "b3b_fourier": (3, 2, [128] + [70] * 8 + [5], 45, True, 2),
    "b2_wave_confined": (3, 1, [3] + [140] * 6 + [7], 117, False, 3),
    "b3b_wave_confined": (3, 1, [128] + [140] * 6 + [7], 37, True, 3),
    "b2_wave_infinite": (3, 1, [3] + [80] * 8 + [7], 53, False, 2),
    "b2_wave_semi_infinite": (3, 1, [3] + [100] * 8 + [7], 41, False, 2),
    "b2_inverse_order2": (3, 2, [3] + [140] * 6 + [7], 37, False, 3),
    "b2_3d": (4, 2, [4] + [100] * 6 + [3], 20, False, 1),
    "b2_elastic3d": (4, 1, [4] + [100] * 6 + [12], 37, False, 2),
    "b2_elastic3d_mms": (4, 1, [4] + [64] * 5 + [12], 45, False, 2),
    "one_layer": (3, 1, [3, 5], 70, False, 2),
    "two_layers": (4, 1, [12, 7, 5], 40, True, 3),
    "four_layers": (4, 2, [9, 11, 6, 8, 4], 66, True, 2),
    "wide140_two_layers": (4, 1, [128, 300, 5], 21, True, 2),
}
# The cases whose widths leave the wide-tile layout one weight buffer (the
# 140-wide nets at 16 points, the 100 x 8 net at 32, a two-layer net at 8),
# so the launcher runs the wide140 body; every other case runs the
# wide-tile body.
WIDE140_CASES = {"b2_wave_confined", "b3b_wave_confined", "b2_inverse_order2",
                 "b2_wave_semi_infinite", "wide140_two_layers"}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_emulated_wide_tile_backward_matches_plain(lib, case):
    """B2/B3b at widths that pick each tile, buffer layout and body, on a
    ragged n that is not a multiple of the tile, with several tiles per block
    and several blocks (so each block's workspace offset is used)."""
    a, order, dims, n, full_dx, max_blocks = WIDE_CASES[case]
    tvjp.reset_launches()
    rng = np.random.default_rng(sum(map(ord, case)))
    s = 1 + a + order - 1
    e = dims[0]
    params = _mlp(rng, dims)
    h0 = torch.as_tensor(rng.uniform(-1, 1, (n, e)), dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((a, n, e)), dtype=torch.float32)
    dtt = (torch.as_tensor(rng.standard_normal((n, e)), dtype=torch.float32)
           if order == 2 else None)
    cot = torch.as_tensor(rng.standard_normal((s, n, dims[-1])),
                          dtype=torch.float32)
    grads, dseed = _mlp_bwd(lib, params, h0, d, dtt, cot, full_dx, max_blocks)
    want, want_seed = tvjp.mlp_jet_bwd_reference(
        _f64(params), h0.double(), d.double(),
        None if dtt is None else dtt.double(), cot.double())
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        _close(g, w)
    _close(dseed, want_seed if full_dx else want_seed[0])
    again = _mlp_bwd(lib, params, h0, d, dtt, cot, full_dx, max_blocks)
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(again), tree_leaves((grads, dseed))))
    body = "wide140" if case in WIDE140_CASES else "tile"
    assert tvjp.BODIES == {**dict.fromkeys(tvjp.BODIES, 0), body: 2}


def test_emulated_backward_workspace_size(lib):
    """The per-block workspace holds every hidden layer's output, all S
    streams, in rows of S * T + 4 floats: T = 32 at the plate widths, the
    80- and 100-wide wave nets and the 64-wide 3D MMS net, 16 for the
    140-wide nets (the wave-confined one, and the inverse problem's at
    order 2) and the 100-wide 3D net (five streams); -1 for a net no tile
    fits."""
    def query(a, order, dims):
        return lib.fused_mlp_jet_bwd_workspace(a, order, _int_array(dims),
                                               len(dims) - 1)

    assert query(3, 2, [128] + [70] * 8 + [5]) == 8 * 70 * (5 * 32 + 4)
    assert query(3, 2, [3] + [70] * 8 + [5]) == 8 * 70 * (5 * 32 + 4)
    assert query(3, 1, [128] + [140] * 6 + [7]) == 6 * 140 * (4 * 16 + 4)
    assert query(3, 1, [3] + [140] * 6 + [7]) == 6 * 140 * (4 * 16 + 4)
    assert query(3, 2, [3] + [140] * 6 + [7]) == 6 * 140 * (5 * 16 + 4)
    assert query(3, 1, [3] + [80] * 8 + [7]) == 8 * 80 * (4 * 32 + 4)
    assert query(3, 1, [3] + [100] * 8 + [7]) == 8 * 100 * (4 * 32 + 4)
    assert query(4, 1, [4] + [100] * 6 + [12]) == 6 * 100 * (5 * 16 + 4)
    assert query(4, 1, [4] + [64] * 5 + [12]) == 5 * 64 * (5 * 32 + 4)
    assert query(3, 1, [3, 2000, 5]) == -1
    assert query(2, 1, [3, 20, 5]) == -1


def _composite_bwd(lib, params, x, cot, order, lb, ub, max_blocks):
    """B5 through the emulated library: (gradients per net, dh0)."""
    n, a = x.shape
    nets = [pack_params(params[k], CPU) for k in tvjp.NETS]
    sizes = [p.numel() for p, _ in nets]
    args, widths = [], []
    for packed, dims in nets:
        args += [packed.data_ptr(), _int_array(dims), len(dims) - 1]
        widths += [_int_array(dims), len(dims) - 1]
    per_block = lib.fused_composite_jet_bwd_workspace(a, order, *widths)
    assert per_block >= 0
    partial = torch.empty(max_blocks, sum(sizes))
    workspace = torch.full((max(1, max_blocks * per_block),), float("nan"))
    grad = torch.empty(sum(sizes))
    dh0 = torch.empty(n, a)
    err = lib.fused_composite_jet_bwd_launch(
        x.data_ptr(), n, a, order, _float_array(lb), _float_array(ub),
        *args, cot.data_ptr(), max_blocks, partial.data_ptr(),
        grad.data_ptr(), dh0.data_ptr(), workspace.data_ptr(), None)
    assert err == 0
    grads = {k: tvjp._unpack_grads(flat, dims) for k, flat, (_, dims)
             in zip(tvjp.NETS, torch.split(grad, sizes), nets)}
    return grads, dh0


def _check_composite_bwd(lib, params, x, cot, order, lb, ub, max_blocks):
    """B5 against its float64 plain version, and two runs bitwise equal."""
    grads, dh0 = _composite_bwd(lib, params, x, cot, order, lb, ub,
                                max_blocks)
    want, want_dh0 = tvjp.composite_jet_bwd_reference(
        _f64(params), x.double(), cot.double(), order=order, lb=lb, ub=ub)
    for k in tvjp.NETS:
        for g, w in zip(tree_leaves(grads[k]), tree_leaves(want[k])):
            _close(g, w)
    _close(dh0, want_dh0)
    again = _composite_bwd(lib, params, x, cot, order, lb, ub, max_blocks)
    assert all(torch.equal(u, v) for u, v in
               zip(tree_leaves(again), tree_leaves((grads, dh0))))


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("a", [3, 4])
def test_emulated_composite_backward_matches_plain(lib, a, order):
    """B5, raw and normalised coordinates, ragged tiles."""
    rng = np.random.default_rng(20 * a + order)
    s = 1 + a + order - 1
    params = {"uv": _mlp(rng, [a, 16, 9, 5]), "dist": _mlp(rng, [a, 7, 5]),
              "part": _mlp(rng, [a, 6, 6, 5])}
    for n, max_blocks in ((37, 3), (8, 1)):
        x = _points(rng, n, a)
        cot = torch.as_tensor(rng.standard_normal((s, n, 5)),
                              dtype=torch.float32)
        for lb, ub in ((None, None), ((0.0,) * a, (0.5,) * (a - 1) + (10.0,))):
            _check_composite_bwd(lib, params, x, cot, order, lb, ub,
                                 max_blocks)


PLATE_LB, PLATE_UB = (0.0, 0.0, 0.0), (0.5, 0.5, 10.0)
# (uv widths, dist/part widths, order, normalised, n, max_blocks): the
# net-BC plate nets (a 32-point tile with two weight buffers), raw and
# normalised, and a 140-wide uv net, which takes a 16-point tile with one
# weight buffer; ragged n, several tiles per block and several blocks.
COMPOSITE_CASES = {
    "plate_raw": ([3] + [70] * 8 + [5], [3] + [20] * 4 + [5], 2, False, 77, 2),
    "plate_lb_ub": ([3] + [70] * 8 + [5], [3] + [20] * 4 + [5], 2, True, 77,
                    2),
    "uv_140_wide": ([3] + [140] * 3 + [5], [3] + [20] * 4 + [5], 1, True, 37,
                    2),
}


@pytest.mark.parametrize("case", sorted(COMPOSITE_CASES))
def test_emulated_composite_backward_at_plate_widths(lib, case):
    """B5 at widths that pick each tile and buffer layout, on a ragged n
    that is not a multiple of the tile, several tiles per block and several
    blocks (so each block's workspace and partial offsets are used)."""
    uv, small, order, norm, n, max_blocks = COMPOSITE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    params = {"uv": _mlp(rng, uv), "dist": _mlp(rng, small),
              "part": _mlp(rng, small)}
    x = _points(rng, n, 3)
    cot = torch.as_tensor(rng.standard_normal((3 + order, n, 5)),
                          dtype=torch.float32)
    lb, ub = (PLATE_LB, PLATE_UB) if norm else (None, None)
    _check_composite_bwd(lib, params, x, cot, order, lb, ub, max_blocks)


def test_emulated_composite_workspace_size(lib):
    """The composite's per-block workspace holds the hidden outputs of its
    deepest net (uv), all S streams, in rows of S * T + 4 floats: T = 32 at
    the plate widths, 16 for a 140-wide uv net; -1 for nets the kernel does
    not take."""
    def query(a, order, uv, small, part=None):
        widths = []
        for dims in (uv, small, part or small):
            widths += [_int_array(dims), len(dims) - 1]
        return lib.fused_composite_jet_bwd_workspace(a, order, *widths)

    uv, small = [3] + [70] * 8 + [5], [3] + [20] * 4 + [5]
    assert query(3, 2, uv, small) == 8 * 70 * (5 * 32 + 4)
    assert query(3, 1, uv, small) == 8 * 70 * (4 * 32 + 4)
    assert query(4, 2, [4] + [70] * 8 + [5], [4, 20, 5]) == 8 * 70 * (6 * 32 + 4)
    assert query(3, 2, [3] + [140] * 3 + [5], small) == 3 * 140 * (5 * 16 + 4)
    assert query(3, 2, small, uv) == 8 * 70 * (5 * 32 + 4)   # deepest net
    assert query(3, 2, [3, 2000, 5], small) == -1            # too wide
    assert query(3, 2, uv, [4, 20, 5]) == -1                 # reads 4 coords
    assert query(3, 2, uv, small, [3, 20, 7]) == -1          # head width
    assert query(2, 2, [2, 20, 5], [2, 20, 5]) == -1         # a out of range
    assert query(3, 3, uv, small) == -1                      # order


@pytest.mark.parametrize("order", [1, 2])
def test_emulated_forward_kernels_match_plain(lib, order):
    """B1 (seeded) and B4 (composite, raw and normalised)."""
    rng = np.random.default_rng(30 + order)
    n, a = 45, 3
    s = 1 + a + order - 1
    params = _mlp(rng, [12, 16, 9, 5])
    h0 = torch.as_tensor(rng.uniform(-1, 1, (n, 12)), dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((a, n, 12)), dtype=torch.float32)
    dtt = (torch.as_tensor(rng.standard_normal((n, 12)), dtype=torch.float32)
           if order == 2 else None)
    packed, dims = pack_params(params, CPU)
    out = torch.empty(s, n, 5)
    assert lib.fused_mlp_jet_launch(
        h0.data_ptr(), d.data_ptr(), None if dtt is None else dtt.data_ptr(),
        n, a, order, packed.data_ptr(), _int_array(dims), len(params),
        out.data_ptr(), None) == 0
    want = tfj.fused_seed_jet_reference(_f64(params), h0.double(), d.double(),
                                        None if dtt is None else dtt.double())
    _close(out, tfj.stack_jet(want))

    comp = {"uv": _mlp(rng, [a, 16, 9, 5]), "dist": _mlp(rng, [a, 7, 5]),
            "part": _mlp(rng, [a, 6, 6, 5])}
    x = _points(rng, n, a)
    args = []
    for k in tvjp.NETS:
        p, dm = pack_params(comp[k], CPU)
        args += [p, dm]
    for lb, ub in ((None, None), ((0.0,) * a, (0.5, 0.5, 10.0))):
        cargs = []
        for i in range(0, 6, 2):
            cargs += [args[i].data_ptr(), _int_array(args[i + 1]),
                      len(args[i + 1]) - 1]
        assert lib.fused_composite_jet_launch(
            x.data_ptr(), n, a, order, _float_array(lb), _float_array(ub),
            *cargs, out.data_ptr(), None) == 0
        want = tfj.fused_composite_jet_reference(_f64(comp), x.double(),
                                                 order=order, lb=lb, ub=ub)
        _close(out, tfj.stack_jet(want))


def test_emulated_forward_kernel_fits_a_wide_net(lib):
    """B1 at the wave-confined Fourier widths (128 -> 140 x 6 -> 7, order
    1), whose two row buffers of 140 rows do not fit in shared memory at the
    plate nets' 56 or 48 points: the launch takes a smaller tile and still
    matches the plain version on a ragged n."""
    rng = np.random.default_rng(33)
    n, a, e = 37, 3, 128
    params = _mlp(rng, [e] + [140] * 6 + [7])
    packed, dims = pack_params(params, CPU)
    floats_at_48 = 2 * 140 * (4 * 48 + 4) + 140 * 140 + 140
    assert 4 * floats_at_48 > 232448     # so 56 or 48 points cannot be it
    h0 = torch.as_tensor(rng.uniform(-1, 1, (n, e)), dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((a, n, e)), dtype=torch.float32)
    out = torch.empty(1 + a, n, 7)
    assert lib.fused_mlp_jet_launch(
        h0.data_ptr(), d.data_ptr(), None, n, a, 1, packed.data_ptr(),
        _int_array(dims), len(params), out.data_ptr(), None) == 0
    want = tfj.fused_seed_jet_reference(_f64(params), h0.double(), d.double())
    _close(out, tfj.stack_jet(want))
    wider = _mlp(rng, [e, 400, 400, 7])
    packed, dims = pack_params(wider, CPU)
    assert lib.fused_mlp_jet_launch(     # too wide even at 8 points
        h0.data_ptr(), d.data_ptr(), None, n, a, 1, packed.data_ptr(),
        _int_array(dims), len(wider), out.data_ptr(), None) != 0


def _mlp_fwd(lib, params, h0, d, dtt):
    """B1 through the emulated library: the (S, n, C) stream stack."""
    packed, dims = pack_params(params, CPU)
    n = h0.shape[0]
    a = d.shape[0]
    order = 2 if dtt is not None else 1
    out = torch.full((1 + a + order - 1, n, dims[-1]), float("nan"))
    assert lib.fused_mlp_jet_launch(
        h0.data_ptr(), d.data_ptr(), None if dtt is None else dtt.data_ptr(),
        n, a, order, packed.data_ptr(), _int_array(dims), len(params),
        out.data_ptr(), None) == 0
    return out


def _composite_fwd(lib, params, x, order, lb, ub):
    """B4 through the emulated library: the (S, n, C) stream stack."""
    n, a = x.shape
    args = []
    nets = [pack_params(params[k], CPU) for k in tvjp.NETS]
    for packed, dims in nets:
        args += [packed.data_ptr(), _int_array(dims), len(dims) - 1]
    out = torch.full((1 + a + order - 1, n, nets[0][1][-1]), float("nan"))
    assert lib.fused_composite_jet_launch(
        x.data_ptr(), n, a, order, _float_array(lb), _float_array(ub),
        *args, out.data_ptr(), None) == 0
    return out


# B1: (seed, a, order, widths, n).  "seeded" takes a random seed of the
# first layer's width (the Fourier embedding's 128), "raw" the seed of
# normalised coordinates.  The 70-wide stacks take items of several
# features, the narrow widths and the heads one-feature items; nets of 1, 2
# and 4 layers take both row buffers in each role.  Ragged n of several
# tiles.
FORWARD_MLP_CASES = {
    "b1_seeded_fourier_order1": ("seeded", 3, 1, [128] + [70] * 8 + [5], 121),
    "b1_seeded_fourier_order2": ("seeded", 3, 2, [128] + [70] * 8 + [5], 121),
    "b1_raw_plate_order1": ("raw", 3, 1, [3] + [70] * 8 + [5], 130),
    "b1_raw_plate_order2": ("raw", 3, 2, [3] + [70] * 8 + [5], 130),
    "b1_raw_3d_order2": ("raw", 4, 2, [4] + [100] * 6 + [3], 41),
    "b1_raw_elastic3d": ("raw", 4, 1, [4] + [100] * 6 + [12], 75),
    "b1_raw_elastic3d_mms": ("raw", 4, 1, [4] + [64] * 5 + [12], 90),
    "b1_raw_wave_infinite": ("raw", 3, 1, [3] + [80] * 8 + [7], 130),
    "b1_raw_wave_semi_infinite": ("raw", 3, 1, [3] + [100] * 8 + [7], 75),
    "b1_raw_inverse_order2": ("raw", 3, 2, [3] + [140] * 6 + [7], 45),
    "b1_one_layer": ("raw", 3, 1, [3, 5], 70),
    "b1_two_layers": ("seeded", 4, 1, [12, 7, 5], 140),
    "b1_four_layers": ("seeded", 4, 2, [9, 11, 6, 8, 4], 66),
}


@pytest.mark.parametrize("case", sorted(FORWARD_MLP_CASES))
def test_emulated_forward_mlp_wide_tile_matches_plain(lib, case):
    """B1 on the wide-tile layer against its float64 plain version, and two
    runs bitwise equal."""
    kind, a, order, dims, n = FORWARD_MLP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    params = _mlp(rng, dims)
    e = dims[0]
    if kind == "raw":
        x = _points(rng, n, a)
        lb, ub = (0.0,) * a, (0.5,) * (a - 1) + (10.0,)
        h0, d, dtt = (None if t is None else t.contiguous()
                      for t in seed_jet(x, order=order, lb=lb, ub=ub))
        want = tfj.fused_jet_reference(_f64(params), x.double(), order=order,
                                       lb=lb, ub=ub)
    else:
        h0 = torch.as_tensor(rng.uniform(-1, 1, (n, e)), dtype=torch.float32)
        d = torch.as_tensor(rng.standard_normal((a, n, e)),
                            dtype=torch.float32)
        dtt = (torch.as_tensor(rng.standard_normal((n, e)),
                               dtype=torch.float32) if order == 2 else None)
        want = tfj.fused_seed_jet_reference(
            _f64(params), h0.double(), d.double(),
            None if dtt is None else dtt.double())
    out = _mlp_fwd(lib, params, h0, d, dtt)
    _close(out, tfj.stack_jet(want))
    assert torch.equal(out, _mlp_fwd(lib, params, h0, d, dtt))


# B4: (a, order, uv widths, dist/part widths, normalised, n): the net-BC
# plate nets (70-wide uv, 20-wide dist and part, which take one-feature
# items), raw and normalised, orders 1 and 2; a 140-wide uv net, which takes
# a smaller tile with one weight buffer; 3D nets.  Ragged n of several tiles.
FORWARD_COMPOSITE_CASES = {
    "b4_plate_raw_order1": (3, 1, [3] + [70] * 8 + [5], [3] + [20] * 4 + [5],
                            False, 150),
    "b4_plate_lb_ub_order2": (3, 2, [3] + [70] * 8 + [5],
                              [3] + [20] * 4 + [5], True, 150),
    "b4_uv_140_wide": (3, 2, [3] + [140] * 3 + [5], [3] + [20] * 4 + [5],
                       True, 37),
    "b4_3d_order2": (4, 2, [4] + [70] * 4 + [3], [4, 20, 3], True, 95),
}


@pytest.mark.parametrize("case", sorted(FORWARD_COMPOSITE_CASES))
def test_emulated_forward_composite_wide_tile_matches_plain(lib, case):
    """B4 on the wide-tile layer against its float64 plain version, and two
    runs bitwise equal."""
    a, order, uv, small, norm, n = FORWARD_COMPOSITE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    params = {"uv": _mlp(rng, uv), "dist": _mlp(rng, small),
              "part": _mlp(rng, small)}
    x = _points(rng, n, a)
    lb, ub = (((0.0,) * a, (0.5,) * (a - 1) + (10.0,)) if norm
              else (None, None))
    out = _composite_fwd(lib, params, x, order, lb, ub)
    want = tfj.fused_composite_jet_reference(_f64(params), x.double(),
                                             order=order, lb=lb, ub=ub)
    _close(out, tfj.stack_jet(want))
    assert torch.equal(out, _composite_fwd(lib, params, x, order, lb, ub))
