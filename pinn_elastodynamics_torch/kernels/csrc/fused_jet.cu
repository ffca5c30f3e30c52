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
// 24 bytes of input and 100 bytes of output, so the f32 CUDA-core rate is the
// roofline.  The design keeps every operand of the FMAs on chip: one block
// owns a tile of T points, holds the activations of all S streams of the
// tile in shared memory (two ping-pong buffers plus the seed), and stages
// each layer's weights into shared memory before the layer runs.  A thread
// computes one output neuron for PG consecutive points of every stream, so
// each weight it loads feeds S * PG FMAs and each float4 of activations
// feeds PG, with the activation loads of a warp broadcast (its lanes share
// the points and differ in the neuron).  The 128-lane padding and VMEM
// blocking of the TPU kernels are not carried over: shared memory holds the
// true widths.
//
// Shared-memory layout: a buffer of width W holds W rows of length RS =
// S * T + 4, element [k * RS + s * T + p] being input feature k of stream s
// at point p of the tile.  The 4-float pad spreads the float4 stores of
// neighbouring neurons over all banks.
//
// The tile is chosen at launch: the largest of 32, 16 and 8 points whose
// buffers fit in shared memory.  The plate nets take 32; wider nets, such
// as a 140-wide Fourier net, a smaller tile.  T is a template parameter, so
// each tile compiles to the same code a fixed tile would.
//
// The launchers take device pointers, sizes and a cudaStream_t, launch on
// that stream without synchronising, and return cudaGetLastError().  They
// are instantiated for 3 or 4 input coordinates (2D or 3D plus time), order
// 1 or 2, and nets of at most MAX_LAYERS layers; anything else, or a net too
// wide for shared memory even at T = 8, returns cudaErrorInvalidValue.

#include "jet_common.cuh"

namespace {

constexpr int PG = 4;           // points per thread item (one float4)

// Layer recurrence of one net over the tile held in `x` (width dims[0]).
// Hidden layers ping-pong between p0 and p1; the head writes `fin`
// (width dims[L]).  All buffers use row stride rs.
template <int S, bool DTT, int TILE>
__device__ void run_net(const Net& net, const float* x, float* p0, float* p1,
                        float* ws, float* bs, float* fin, int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);  // tangent streams
  const float* in = x;
  for (int l = 0; l < net.n_layers; ++l) {
    const int fi = net.dims[l];
    const int fo = net.dims[l + 1];
    const bool last = (l == net.n_layers - 1);
    float* dst = last ? fin : ((l & 1) ? p1 : p0);
    __syncthreads();  // the previous layer is done with ws and with dst
    const float* wg = net.w[l];
    for (int i = threadIdx.x; i < fi * fo; i += blockDim.x) ws[i] = wg[i];
    for (int i = threadIdx.x; i < fo; i += blockDim.x) bs[i] = net.b[l][i];
    __syncthreads();

    const int items = fo * (TILE / PG);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int j = it % fo;
      const int q0 = (it / fo) * PG;
      float acc[S][PG];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < PG; ++q) acc[s][q] = 0.0f;

      const float* col = in + q0;
      for (int k = 0; k < fi; ++k) {
        const float w = ws[k * fo + j];
        const float* row = col + k * rs;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(row + s * TILE);
          acc[s][0] = fmaf(a.x, w, acc[s][0]);
          acc[s][1] = fmaf(a.y, w, acc[s][1]);
          acc[s][2] = fmaf(a.z, w, acc[s][2]);
          acc[s][3] = fmaf(a.w, w, acc[s][3]);
        }
      }

      const float bj = bs[j];
#pragma unroll
      for (int q = 0; q < PG; ++q) {
        if (last) {
          acc[0][q] += bj;
        } else {
          const float h = tanhf(acc[0][q] + bj);
          const float g = 1.0f - h * h;
          if (DTT) {
            const float zt = acc[NT][q];
            acc[S - 1][q] = g * acc[S - 1][q] - 2.0f * h * g * (zt * zt);
          }
#pragma unroll
          for (int s = 1; s <= NT; ++s) acc[s][q] *= g;
          acc[0][q] = h;
        }
      }
      float* out = dst + j * rs + q0;
#pragma unroll
      for (int s = 0; s < S; ++s)
        *reinterpret_cast<float4*>(out + s * TILE) =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    }
    in = dst;
  }
  __syncthreads();
}

template <int S, bool DTT, int TILE>
__global__ void mlp_jet_kernel(const float* __restrict__ seed_f,
                               const float* __restrict__ seed_d,
                               const float* __restrict__ seed_tt, int n,
                               Net net, int hid, int wmax,
                               float* __restrict__ out, int rs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int e = net.dims[0];
  const int c = net.dims[net.n_layers];
  float* x = smem;
  float* p0 = x + e * rs;
  float* p1 = p0 + hid * rs;
  float* fin = p1 + hid * rs;
  float* ws = fin + c * rs;
  float* bs = ws + ((wmax + 3) & ~3);

  const int n0 = blockIdx.x * TILE;
  const int nvalid = min(TILE, n - n0);
  for (int i = threadIdx.x; i < S * TILE * e; i += blockDim.x) {
    const int k = i % e;
    const int sp = i / e;
    const int p = sp % TILE;
    const int s = sp / TILE;
    float v = 0.0f;
    if (p < nvalid) {
      const size_t pt = static_cast<size_t>(n0 + p) * e + k;
      if (s == 0)
        v = seed_f[pt];
      else if (DTT && s == S - 1)
        v = seed_tt[pt];
      else
        v = seed_d[static_cast<size_t>(s - 1) * n * e + pt];
    }
    x[k * rs + s * TILE + p] = v;
  }

  run_net<S, DTT, TILE>(net, x, p0, p1, ws, bs, fin, rs);

  for (int i = threadIdx.x; i < S * TILE * c; i += blockDim.x) {
    const int ch = i % c;
    const int sp = i / c;
    const int p = sp % TILE;
    const int s = sp / TILE;
    if (p < nvalid)
      out[(static_cast<size_t>(s) * n + n0 + p) * c + ch] =
          fin[ch * rs + s * TILE + p];
  }
}

template <int S, bool DTT, int TILE>
__global__ void composite_jet_kernel(const float* __restrict__ xg, int n,
                                     int a, Norm norm, Net nu, Net nd, Net np,
                                     int hid, int wmax, float* __restrict__ out,
                                     int rs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const int c = nu.dims[nu.n_layers];
  float* x = smem;
  float* p0 = x + a * rs;
  float* p1 = p0 + hid * rs;
  float* fu = p1 + hid * rs;
  float* fd = fu + c * rs;
  float* fp = fd + c * rs;
  float* ws = fp + c * rs;
  float* bs = ws + ((wmax + 3) & ~3);

  // Seed of raw (or normalized) coordinates: value, identity tangents
  // (scaled by the normalization), zero dtt.
  const int n0 = blockIdx.x * TILE;
  const int nvalid = min(TILE, n - n0);
  for (int i = threadIdx.x; i < S * TILE * a; i += blockDim.x) {
    const int k = i % a;
    const int sp = i / a;
    const int p = sp % TILE;
    const int s = sp / TILE;
    float v = 0.0f;
    if (s > 0 || p < nvalid)
      v = seed_value(norm, s, k, NT,
                     s == 0 ? xg[static_cast<size_t>(n0 + p) * a + k] : 0.0f);
    x[k * rs + s * TILE + p] = v;
  }

  run_net<S, DTT, TILE>(nu, x, p0, p1, ws, bs, fu, rs);
  run_net<S, DTT, TILE>(nd, x, p0, p1, ws, bs, fd, rs);
  run_net<S, DTT, TILE>(np, x, p0, p1, ws, bs, fp, rs);

  for (int i = threadIdx.x; i < TILE * c; i += blockDim.x) {
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
      const int r = s * TILE;
      out[s * sstride + base] = q[r] + d[r] * uf + df * u[r];
    }
    if (DTT) {
      const int t = NT * TILE;
      const int r = (S - 1) * TILE;
      out[(S - 1) * sstride + base] =
          q[r] + d[r] * uf + 2.0f * d[t] * u[t] + df * u[r];
    }
  }
}

int block_threads(const Net* nets, int count, int tile) {
  int widest = 1;
  for (int i = 0; i < count; ++i)
    for (int l = 1; l <= nets[i].n_layers; ++l)
      widest = std::max(widest, nets[i].dims[l]);
  return std::min(1024, std::max(64, round_up(widest * (tile / PG), 32)));
}

template <int S, bool DTT>
int launch_mlp(const float* sf, const float* sd, const float* stt, int n,
               const Net& net, float* out, cudaStream_t stream) {
  int hid = 0, wmax = 0, bmax = 0;
  net_sizes(net, &hid, &wmax, &bmax);
  const int c = net.dims[net.n_layers];
  size_t bytes = 0;
  const int t = pick_tile(S, net.dims[0] + 2L * hid + c,
                          round_up(wmax, 4) + bmax, 32, 8, &bytes);
  if (t == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rs = S * t + 4;
  const auto kern = t == 32   ? mlp_jet_kernel<S, DTT, 32>
                    : t == 16 ? mlp_jet_kernel<S, DTT, 16>
                              : mlp_jet_kernel<S, DTT, 8>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int blocks = (n + t - 1) / t;
  kern<<<blocks, block_threads(&net, 1, t), bytes, stream>>>(
      sf, sd, stt, n, net, hid, wmax, out, rs);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool DTT>
int launch_composite(const float* x, int n, int a, const Norm& norm,
                     const Net* nets, float* out, cudaStream_t stream) {
  int hid = 0, wmax = 0, bmax = 0;
  for (int i = 0; i < 3; ++i) net_sizes(nets[i], &hid, &wmax, &bmax);
  const int c = nets[0].dims[nets[0].n_layers];
  size_t bytes = 0;
  const int t = pick_tile(S, a + 2L * hid + 3L * c, round_up(wmax, 4) + bmax,
                          32, 8, &bytes);
  if (t == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rs = S * t + 4;
  const auto kern = t == 32   ? composite_jet_kernel<S, DTT, 32>
                    : t == 16 ? composite_jet_kernel<S, DTT, 16>
                              : composite_jet_kernel<S, DTT, 8>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int blocks = (n + t - 1) / t;
  kern<<<blocks, block_threads(nets, 3, t), bytes, stream>>>(
      x, n, a, norm, nets[0], nets[1], nets[2], hid, wmax, out, rs);
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
