// Fused tanh-MLP jet forward kernels for Hopper (sm_90a), plain C interface.
//
// Two kernels, each replacing a Pallas TPU kernel of the JAX package:
//
//   mlp_jet_kernel        replaces pinn_elastodynamics_tpu/kernels/fused_jet.py
//                         ::_kernel / _run_layers (launched by
//                         _fused_jet_padded).  Whole-MLP jet forward from
//                         caller-supplied seed streams: value, A tangents and,
//                         with DTT, the second time derivative.
//   composite_jet_kernel  replaces fused_jet.py::_composite_kernel (launched
//                         by _fused_composite_padded).  The uv, dist and part
//                         nets on one tile of raw points, combined by the
//                         product rule into part + dist * uv.
//
// Arithmetic per hidden layer, as _run_layers: z = s . W over all S streams,
// h = tanh(z_0 + b), g = 1 - h^2, tangents g * z_i, and
// dtt = g * z_tt - 2 h g z_t^2.  The bias goes on the value stream only; the
// linear head adds its bias to the value stream only.  Everything is IEEE
// f32 on the CUDA cores (FFMA, tanhf): no TF32, no fast-math intrinsics.
//
// What bounds it on an H100: operations.  A point costs 2 * S * sum(fan_in *
// fan_out) FLOPs (about 0.3 MFLOP for the plate nets at S = 4) against 12 to
// 24 bytes of input (512 to 640 for a Fourier seed) and 80 to 100 bytes of
// output, so the f32 CUDA-core rate is the roofline.  What holds a kernel
// below it is shared memory and latency: a float4 of activations loaded
// from shared memory feeds 4 FMAs per output feature of the item, and the
// tile's accumulators (features x streams x points) must spread over enough
// warps to hide the loads.
//
// The design is the wide-tile layer of jet_wide.cuh, the device functions
// the backward kernels of fused_jet_vjp.cu run for their remat: each net
// goes through remat_net (saving nothing) and head_forward.  A block owns a
// tile of T points with all S streams in shared memory and stages each
// layer's weights by cp.async into one of two buffers while the previous
// layer runs.  Products are register blocked: an item computes F output
// features for 4 points of every stream (narrow layers, such as the 20-wide
// dist and part nets and the heads, take one feature), each output as the
// same sequential fmaf chain over the layer's inputs as a one-feature
// kernel computes, so the item shape does not change a bit of the result.
// What the forward does beyond the backward's remat is about tile size.
// It keeps no layer past the next, so its activations ping-pong between two
// row buffers (FWD_NB) instead of the backward's three, and the freed shared
// memory buys larger tiles, hence more items per layer.  The time of a
// layer follows the most warps any of the SM's four schedulers runs, times
// the cost of one item (about proportional to its features): so each
// kernel's design (Design below) pairs a tile and an item width whose items
// fill whole warps spread evenly over the schedulers, at the tile's
// register budget.  mlp_jet_kernel: 56-point tiles of 4-feature items (8
// warps at 70 features) with four streams; with five, 64-point tiles of
// 3-feature items (12 warps), or 40 points for a 128-wide Fourier seed,
// whose buffers fit no more.  composite_jet_kernel: 64-point tiles of
// 3-feature items.  scripts/torch_fwd_sweep.py times these against the
// alternatives (PERF.md).  mlp_jet_kernel gathers its seed into act[0]'s
// row buffer and writes the head into act[L]'s; composite_jet_kernel
// builds the seed of raw (or normalised) x once per tile into a buffer of
// its own, runs uv, dist and part into three head buffers (the weight
// buffers are keyed by net and layer) and combines them.  The launchers
// start one block per tile; the kernels also walk tiles b, b + G, ... for a
// smaller grid G, which the sweep times (0.96 to 1.03 of one block per
// tile, no side ahead).
//
// The tile is chosen at launch: the first of the design's tiles whose
// buffers fit in shared memory (the 140-wide wave-confined net takes 32),
// with two weight buffers where they fit.
// T is a template parameter, so each tile compiles to the same code a fixed
// tile would.
//
// The launchers take device pointers, sizes and a cudaStream_t, launch on
// that stream without synchronising, and return cudaGetLastError().  They
// are instantiated for 3 or 4 input coordinates (2D or 3D plus time), order
// 1 or 2, and nets of at most MAX_LAYERS layers; anything else, or a net too
// wide for shared memory even at T = 8, returns cudaErrorInvalidValue.

#include "jet_wide.cuh"

#include <type_traits>

namespace {

// The design of each kernel: output features per item of a wide layer,
// the most threads a block may have (its launch bound), and the tiles a
// launch may take, largest first (scripts/torch_fwd_sweep.py times the
// alternatives; PERF.md).
template <int F, int THREADS, int... Ts>
struct Design {
  static constexpr int fb = F;
  static constexpr int threads = THREADS;
  static constexpr int tiles[] = {Ts..., 0};
};

using MlpDesign4 = Design<4, 256, 56, 48, 32, 16, 8>;   // four streams
using MlpDesign5 = Design<3, 384, 64, 40, 32, 16, 8>;   // five or six
using CompositeDesign = Design<3, 384, 64, 56, 48, 32, 16, 8>;

template <int S>
using MlpDesign = std::conditional_t<S <= 4, MlpDesign4, MlpDesign5>;
constexpr int FWD_NB = 2;  // row buffers: act[m] in buffer m % 2

template <int S, bool DTT, int T>
__global__ void __launch_bounds__(MlpDesign<S>::threads, 1)
mlp_jet_kernel(const float* __restrict__ seed_f,
               const float* __restrict__ seed_d,
               const float* __restrict__ seed_tt, int n, Net net,
               wide::Layout lay, float* __restrict__ out) {
  using namespace wide;
  constexpr int F = MlpDesign<S>::fb;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = net.n_layers;
  const int e = net.dims[0];
  const int c = net.dims[L];
  const int rs = lay.rs;
  float* fin = smem + lay.buf[row_buffer<FWD_NB>(L, L)];  // act[L], the head
  int held[2] = {-1, -1};
  auto no_cot = [](float*) {};

  const int tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * T;
    const int nvalid = min(T, n - n0);
    auto seed = [&](float* dst) -> const float* {
      gather_seed<S, DTT, T>(seed_f, seed_d, seed_tt, n, n0, nvalid, e, rs,
                             dst);
      return dst;
    };
    __syncthreads();  // the previous tile is done with shared memory
    const float* s0 = remat_net<S, DTT, T, F, FWD_NB>(
        net, 0, lay, smem, held, nullptr, seed, no_cot);
    head_forward<S, DTT, T, F, FWD_NB>(net, 0, lay, smem, held, s0, fin);
    __syncthreads();
    for (int i = threadIdx.x; i < S * T * c; i += blockDim.x) {
      const int ch = i % c;
      const int p = (i / c) % T;
      const int s = i / (c * T);
      if (p < nvalid)
        out[(static_cast<size_t>(s) * n + n0 + p) * c + ch] =
            fin[ch * rs + s * T + p];
    }
  }
}

template <int S, bool DTT, int T>
__global__ void __launch_bounds__(CompositeDesign::threads, 1)
composite_jet_kernel(const float* __restrict__ xg, int n, int a, Norm norm,
                     Net nu, Net nd, Net np, wide::Layout lay,
                     float* __restrict__ out) {
  using namespace wide;
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  constexpr int F = CompositeDesign::fb;
  enum { UV, DIST, PART };
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rs = lay.rs;
  const int c = nu.dims[nu.n_layers];
  float* fu = smem + lay.extra;  // the three nets' output jets
  float* fd = fu + c * rs;
  float* fp = fd + c * rs;
  float* s0 = fp + c * rs;       // seed streams, width a
  int held[2] = {-1, -1};
  auto seed = [&](float*) -> const float* { return s0; };
  auto no_cot = [](float*) {};

  const int tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * T;
    const int nvalid = min(T, n - n0);
    __syncthreads();  // the previous tile is done with shared memory
    // Seed of raw (or normalised) coordinates: value, identity tangents
    // (scaled by the normalisation), zero dtt.
    for (int i = threadIdx.x; i < S * T * a; i += blockDim.x) {
      const int k = i % a;
      const int p = (i / a) % T;
      const int s = i / (a * T);
      s0[k * rs + s * T + p] =
          p < nvalid
              ? seed_value(norm, s, k, NT,
                           s == 0 ? xg[static_cast<size_t>(n0 + p) * a + k]
                                  : 0.0f)
              : 0.0f;
    }
    remat_net<S, DTT, T, F, FWD_NB>(nu, UV, lay, smem, held, nullptr,
                                    seed, no_cot);
    head_forward<S, DTT, T, F, FWD_NB>(nu, UV, lay, smem, held, s0, fu);
    __syncthreads();
    remat_net<S, DTT, T, F, FWD_NB>(nd, DIST, lay, smem, held, nullptr,
                                    seed, no_cot);
    head_forward<S, DTT, T, F, FWD_NB>(nd, DIST, lay, smem, held, s0, fd);
    __syncthreads();
    remat_net<S, DTT, T, F, FWD_NB>(np, PART, lay, smem, held, nullptr,
                                    seed, no_cot);
    head_forward<S, DTT, T, F, FWD_NB>(np, PART, lay, smem, held, s0, fp);
    __syncthreads();

    for (int i = threadIdx.x; i < T * c; i += blockDim.x) {
      const int ch = i % c;
      const int p = i / c;
      if (p >= nvalid) continue;
      const float* u = fu + ch * rs + p;
      const float* d = fd + ch * rs + p;
      const float* q = fp + ch * rs + p;
      const float uf = u[0];
      const float df = d[0];
      const size_t base = static_cast<size_t>(n0 + p) * c + ch;
      const size_t sstride = static_cast<size_t>(n) * c;
      out[base] = q[0] + df * uf;
#pragma unroll
      for (int s = 1; s <= NT; ++s) {
        const int r = s * T;
        out[s * sstride + base] = q[r] + d[r] * uf + df * u[r];
      }
      if (DTT) {
        const int t = NT * T;
        const int r = (S - 1) * T;
        out[(S - 1) * sstride + base] =
            q[r] + d[r] * uf + 2.0f * d[t] * u[t] + df * u[r];
      }
    }
  }
}

using MlpKernel = void (*)(const float*, const float*, const float*, int, Net,
                           wide::Layout, float*);
using CompositeKernel = void (*)(const float*, int, int, Norm, Net, Net, Net,
                                 wide::Layout, float*);

// The instance of tile t, one of the design's tiles.
template <int S, bool DTT, int F, int TH, int... Ts>
MlpKernel mlp_kernel(int t, Design<F, TH, Ts...>) {
  MlpKernel k = nullptr;
  ((k = t == Ts ? mlp_jet_kernel<S, DTT, Ts> : k), ...);
  return k;
}

template <int S, bool DTT, int F, int TH, int... Ts>
CompositeKernel composite_kernel(int t, Design<F, TH, Ts...>) {
  CompositeKernel k = nullptr;
  ((k = t == Ts ? composite_jet_kernel<S, DTT, Ts> : k), ...);
  return k;
}

// The layouts: one net, or the composite's three nets, then its fu, fd and
// fp buffers (head width each) and its seed (width a).
template <int S>
size_t mlp_layout(const Net& net, wide::Layout* lay) {
  using D = MlpDesign<S>;
  return wide_layout(&net, 1, S, 0, 0, lay, D::fb, D::tiles, FWD_NB,
                     D::threads);
}

size_t composite_layout(const Net* nets, int s, int a, wide::Layout* lay) {
  return wide_layout(nets, 3, s, 3 * nets[0].dims[nets[0].n_layers] + a, 0,
                     lay, CompositeDesign::fb, CompositeDesign::tiles, FWD_NB,
                     CompositeDesign::threads);
}

template <int S, bool DTT>
int launch_mlp(const float* sf, const float* sd, const float* stt, int n,
               const Net& net, float* out, cudaStream_t stream) {
  wide::Layout lay;
  const size_t bytes = mlp_layout<S>(net, &lay);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = mlp_kernel<S, DTT>(lay.T, MlpDesign<S>());
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int blocks = (n + lay.T - 1) / lay.T;  // one tile per block
  kern<<<blocks, lay.threads, bytes, stream>>>(sf, sd, stt, n, net, lay, out);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool DTT>
int launch_composite(const float* x, int n, int a, const Norm& norm,
                     const Net* nets, float* out, cudaStream_t stream) {
  wide::Layout lay;
  const size_t bytes = composite_layout(nets, S, a, &lay);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = composite_kernel<S, DTT>(lay.T, CompositeDesign());
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int blocks = (n + lay.T - 1) / lay.T;  // one tile per block
  kern<<<blocks, lay.threads, bytes, stream>>>(
      x, n, a, norm, nets[0], nets[1], nets[2], lay, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fused_jet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// seed_f: (n, E); seed_d: (A, n, E); seed_tt: (n, E) when order == 2, else
// unused; packed: per layer W (row-major) then b; dims: n_layers + 1 widths,
// dims[0] == E; out: (S, n, C) with S = 1 + A (+1 when order == 2).
int fused_mlp_jet_launch(const float* seed_f, const float* seed_d,
                         const float* seed_tt, int n, int n_tangents,
                         int order, const float* packed, const int* dims,
                         int n_layers, float* out, void* stream) {
  Net net;
  if (!make_net(packed, dims, n_layers, &net) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = n_tangents * 2 + (order == 2 ? 1 : 0);
  switch (key) {
    case 6: return launch_mlp<4, false>(seed_f, seed_d, seed_tt, n, net, out, st);
    case 7: return launch_mlp<5, true>(seed_f, seed_d, seed_tt, n, net, out, st);
    case 8: return launch_mlp<5, false>(seed_f, seed_d, seed_tt, n, net, out, st);
    case 9: return launch_mlp<6, true>(seed_f, seed_d, seed_tt, n, net, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (n, a) raw points; lb/ub: a floats each, or both null for raw
// coordinates; pu/pd/pp and du/dd/dp: the uv, dist and part nets packed as
// for fused_mlp_jet_launch; out: (S, n, C) with S = 1 + a (+1 for order 2).
int fused_composite_jet_launch(const float* x, int n, int a, int order,
                               const float* lb, const float* ub,
                               const float* pu, const int* du, int lu,
                               const float* pd, const int* dd, int ld,
                               const float* pp, const int* dp, int lp,
                               float* out, void* stream) {
  Net nets[3];
  if (!make_net(pu, du, lu, &nets[0]) || !make_net(pd, dd, ld, &nets[1]) ||
      !make_net(pp, dp, lp, &nets[2]) || n < 0 || a < 3 || a > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = nets[0].dims[lu];
  for (int i = 0; i < 3; ++i)
    if (nets[i].dims[0] != a || nets[i].dims[nets[i].n_layers] != c)
      return static_cast<int>(cudaErrorInvalidValue);
  const Norm norm = make_norm(lb, ub, a);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = a * 2 + (order == 2 ? 1 : 0);
  switch (key) {
    case 6: return launch_composite<4, false>(x, n, a, norm, nets, out, st);
    case 7: return launch_composite<5, true>(x, n, a, norm, nets, out, st);
    case 8: return launch_composite<5, false>(x, n, a, norm, nets, out, st);
    case 9: return launch_composite<6, true>(x, n, a, norm, nets, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
