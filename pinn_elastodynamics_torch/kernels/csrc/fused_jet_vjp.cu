// Backward kernels of the fused tanh-MLP jets for Hopper (sm_90a), plain C
// interface.
//
// Two kernel bodies, each replacing Pallas TPU kernels of the JAX package
// (pinn_elastodynamics_tpu/kernels/fused_jet_vjp.py):
//
//   mlp_jet_bwd_kernel        replaces _bwd_kernel with _remat_forward and
//                             _reverse_sweep, launched by
//                             _fused_jet_bwd_padded (B2: value-row seed
//                             cotangent) and _fused_seed_bwd_padded (B3b:
//                             the full seed cotangent, full_dx).
//   composite_jet_bwd_kernel  replaces _composite_bwd_kernel and _final_out,
//                             launched by _fused_composite_bwd_padded (B5):
//                             remat of the uv, dist and part nets, reverse of
//                             the product-rule combine part + dist * uv,
//                             three reverse sweeps, the value-row seed
//                             cotangents summed.
//
// The reverse recurrence of a hidden layer (streams: value h, tangents,
// optional dtt; z = s_in W, h = tanh(z_0 + b), g = 1 - h^2), from the
// cotangents c_h, c_i, c_tt of its output:
//   chh  = c_h - 2h sum_i c_i z_i  (+ c_tt (-2h z_tt - 2(1 - 3h^2) z_t^2))
//   c'_i = g c_i                   (+ for the t-tangent, the LAST tangent
//                                      stream: c_tt (-4 h g z_t))
//   c'_tt = g c_tt,  c'_0 = g chh
//   dW += s_in^T [c'_0; c'_i; c'_tt],  db += sum over points of c'_0,
//   c_in = [c'_0; c'_i; c'_tt] W^T.
// The linear head: dW += s_in^T c over every stream, db += the value rows.
// Everything is IEEE f32 on the CUDA cores (FFMA, tanhf): no TF32, no fast
// math, as in the forward kernels.
//
// What bounds it on an H100: operations.  Per point the function needs the
// forward once (2 S sum fan_in fan_out FLOPs), the weight gradients and the
// input cotangents (2 S sum fan_in fan_out each): three times the forward,
// against a few hundred bytes of seed, cotangent and result per point.  This
// kernel also recomputes the non-value pre-activations of every hidden layer
// in the reverse sweep (2 (S - 1) sum over hidden layers), which saves
// shared memory and is not work the function needs.
//
// Design.  The Pallas kernels zero dW/db at grid step 0 and accumulate into
// an output block that every step revisits, which is safe only because a
// TPU grid runs in order.  Here a fixed number of blocks (at most one per
// SM) each walk their tiles of T points in a fixed order (tile b, b + G,
// b + 2G, ...) and keep ONE partial gradient per block in global memory (the
// packed parameter layout; a block's partial stays in L2).  A thread owns the
// same gradient elements in every tile, so the read-modify-write needs no
// synchronisation.  A second kernel sums the G partials in block order.  No
// float atomics: two runs give bitwise-equal gradients.
//
// The remat keeps every layer's input for all S streams of the tile in
// shared memory: a buffer of width W is W rows of RS = S * T + 4 floats,
// element [k * RS + s * T + p] being feature k of stream s at point p.  At
// the plate widths that is 563 (uv), 688 (Fourier tail) or 723 (three
// composite nets) rows, so T = 8 points per tile (T = 4 where 8 does not
// fit, as for 3D order 2 with a Fourier tail): 99 KB to 127 KB of
// activations, 143 KB to 202 KB in all, one block per SM.  Matrix products
// give one thread one output feature for PG = 4 points of every stream (the
// forward kernels' item), so the tanh-jet epilogue and the reverse of it run
// in registers; the z of the non-value streams is recomputed in the same
// item that applies the reverse recurrence, so it is never stored.
//
// The launchers take device pointers, sizes and a cudaStream_t, launch the
// main kernel and the reduction on that stream without synchronising, and
// return cudaGetLastError().  They are instantiated for 3 or 4 input
// coordinates, order 1 or 2; anything else, or a net too wide for shared
// memory, returns cudaErrorInvalidValue.

#include "jet_common.cuh"

namespace {

constexpr int PG = 4;            // points per thread item (one float4)
constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 256;

struct Tile {
  int T;       // points per tile
  int rs;      // row stride of a shared buffer, S * T + 4
};

// Offsets of layer l's W and b in the packed buffer.
__device__ __forceinline__ void packed_offsets(const Net& net, int l,
                                               int* w_off, int* b_off) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += (net.dims[i] + 1) * net.dims[i + 1];
  *w_off = off;
  *b_off = off + net.dims[l] * net.dims[l + 1];
}

// Copy layer l's weights and bias into shared memory.
__device__ void stage(const Net& net, int l, float* ws, float* bs) {
  __syncthreads();  // every reader of the previous contents is done
  const int n_w = net.dims[l] * net.dims[l + 1];
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) ws[i] = net.w[l][i];
  for (int i = threadIdx.x; i < net.dims[l + 1]; i += blockDim.x)
    bs[i] = net.b[l][i];
  __syncthreads();
}

// out = layer(in): the jet of a hidden tanh layer, or with `head` the
// linear head (bias on the value rows only).
template <int S, bool DTT>
__device__ void forward_layer(const float* in, int fi, int fo,
                              const float* ws, const float* bs, float* out,
                              bool head, Tile tl) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const int items = fo * (tl.T / PG);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j = it % fo;
    const int q0 = (it / fo) * PG;
    float acc[S][PG];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int q = 0; q < PG; ++q) acc[s][q] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < fi; ++k) {
      const float w = ws[k * fo + j];
      const float* row = in + k * tl.rs + q0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * tl.T);
        acc[s][0] = fmaf(a.x, w, acc[s][0]);
        acc[s][1] = fmaf(a.y, w, acc[s][1]);
        acc[s][2] = fmaf(a.z, w, acc[s][2]);
        acc[s][3] = fmaf(a.w, w, acc[s][3]);
      }
    }
    const float bj = bs[j];
#pragma unroll
    for (int q = 0; q < PG; ++q) {
      if (head) {
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
    float* dst = out + j * tl.rs + q0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(dst + s * tl.T) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
  }
}

// Reverse of one hidden layer's tanh-jet epilogue, in place: c holds the
// cotangent of the layer's output (width fo) and receives [c'_0; c'_i;
// c'_tt].  z of the non-value streams is recomputed from s_in; h is the
// saved output's value row.
template <int S, bool DTT>
__device__ void reverse_epilogue(float* c, const float* s_in,
                                 const float* s_out, int fi, int fo,
                                 const float* ws, Tile tl) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const int items = fo * (tl.T / PG);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j = it % fo;
    const int q0 = (it / fo) * PG;
    float z[S][PG];  // z[0] unused: the value stream needs no recompute
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int q = 0; q < PG; ++q) z[s][q] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < fi; ++k) {
      const float w = ws[k * fo + j];
      const float* row = s_in + k * tl.rs + q0;
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * tl.T);
        z[s][0] = fmaf(a.x, w, z[s][0]);
        z[s][1] = fmaf(a.y, w, z[s][1]);
        z[s][2] = fmaf(a.z, w, z[s][2]);
        z[s][3] = fmaf(a.w, w, z[s][3]);
      }
    }
    float* col = c + j * tl.rs + q0;
    const float4 h4 = *reinterpret_cast<const float4*>(s_out + j * tl.rs + q0);
    const float hv[PG] = {h4.x, h4.y, h4.z, h4.w};
    float cv[S][PG];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(col + s * tl.T);
      cv[s][0] = v.x;
      cv[s][1] = v.y;
      cv[s][2] = v.z;
      cv[s][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < PG; ++q) {
      const float h = hv[q];
      const float g = 1.0f - h * h;
      float acc = 0.0f;
#pragma unroll
      for (int t = 1; t <= NT; ++t) acc += cv[t][q] * z[t][q];
      float chh = cv[0][q] - 2.0f * h * acc;
      float ct[S];
#pragma unroll
      for (int t = 1; t <= NT; ++t) ct[t] = g * cv[t][q];
      if (DTT) {
        const float zt = z[NT][q];
        const float ztt = z[S - 1][q];
        const float ctt = cv[S - 1][q];
        chh += ctt * (-2.0f * h * ztt - 2.0f * (1.0f - 3.0f * h * h) * (zt * zt));
        ct[NT] += ctt * (-4.0f * h * g * zt);
        ct[S - 1] = g * ctt;
      }
      ct[0] = g * chh;
#pragma unroll
      for (int s = 0; s < S; ++s) cv[s][q] = ct[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(col + s * tl.T) =
          make_float4(cv[s][0], cv[s][1], cv[s][2], cv[s][3]);
  }
}

// c_in = c W^T: cotangent of the layer's input (width fi) from the stacked
// cotangent c of its pre-activation (width fo).
template <int S>
__device__ void backward_product(const float* c, int fo, const float* ws,
                                 int fi, float* out, Tile tl) {
  const int items = fi * (tl.T / PG);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int k = it % fi;
    const int q0 = (it / fi) * PG;
    float acc[S][PG];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int q = 0; q < PG; ++q) acc[s][q] = 0.0f;
    const float* wrow = ws + k * fo;
#pragma unroll 4
    for (int j = 0; j < fo; ++j) {
      const float w = wrow[j];
      const float* row = c + j * tl.rs + q0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * tl.T);
        acc[s][0] = fmaf(a.x, w, acc[s][0]);
        acc[s][1] = fmaf(a.y, w, acc[s][1]);
        acc[s][2] = fmaf(a.z, w, acc[s][2]);
        acc[s][3] = fmaf(a.w, w, acc[s][3]);
      }
    }
    float* dst = out + k * tl.rs + q0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(dst + s * tl.T) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
  }
}

// The tile's dW = s_in^T c over every stream and db = the value rows of c,
// stored into (first tile of the block) or added to the block's partial.
// A thread owns KB consecutive rows k of one column j, so each float4 of c
// it loads feeds KB dot products (the loads of s_in are shared by the lanes
// of a warp, which differ in j).
template <int S>
__device__ void accumulate_grads(const float* s_in, int fi, const float* c,
                                 int fo, float* gw, float* gb, bool first,
                                 Tile tl) {
  constexpr int KB = 4;
  const int rows = S * tl.T;
  const int items = (fi + KB - 1) / KB * fo;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int j = e % fo;
    const int k0 = (e / fo) * KB;
    const float* b = c + j * tl.rs;
    const float* a[KB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
      a[kk] = s_in + min(k0 + kk, fi - 1) * tl.rs;  // clamped; not stored
    float acc[KB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) acc[kk] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < rows; r += 4) {
      const float4 y = *reinterpret_cast<const float4*>(b + r);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(a[kk] + r);
        acc[kk] = fmaf(x.x, y.x, acc[kk]);
        acc[kk] = fmaf(x.y, y.y, acc[kk]);
        acc[kk] = fmaf(x.z, y.z, acc[kk]);
        acc[kk] = fmaf(x.w, y.w, acc[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      if (k0 + kk < fi) {
        float* w = gw + (k0 + kk) * fo + j;
        *w = first ? acc[kk] : *w + acc[kk];
      }
    }
  }
  for (int j = threadIdx.x; j < fo; j += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < tl.T; ++p) acc += c[j * tl.rs + p];
    gb[j] = first ? acc : gb[j] + acc;
  }
}

// Remat of a net's hidden layers: act[l + 1] = layer l (act[l]).
template <int S, bool DTT>
__device__ void remat_net(const Net& net, float* const* act, float* ws,
                          float* bs, Tile tl) {
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    stage(net, l, ws, bs);
    forward_layer<S, DTT>(act[l], net.dims[l], net.dims[l + 1], ws, bs,
                          act[l + 1], false, tl);
  }
}

// Reverse sweep of one net from the output cotangent in *c1 (width of the
// head), accumulating into the net's partial gradient `g`.  On return *c1
// points at the seed cotangent (width dims[0]); *c2 is free.
template <int S, bool DTT>
__device__ void reverse_net(const Net& net, float* const* act, float** c1,
                            float** c2, float* ws, float* bs, float* g,
                            bool first, Tile tl) {
  for (int l = net.n_layers - 1; l >= 0; --l) {
    const int fi = net.dims[l];
    const int fo = net.dims[l + 1];
    stage(net, l, ws, bs);
    if (l + 1 < net.n_layers) {
      reverse_epilogue<S, DTT>(*c1, act[l], act[l + 1], fi, fo, ws, tl);
      __syncthreads();
    }
    int w_off, b_off;
    packed_offsets(net, l, &w_off, &b_off);
    accumulate_grads<S>(act[l], fi, *c1, fo, g + w_off, g + b_off, first, tl);
    backward_product<S>(*c1, fo, ws, fi, *c2, tl);
    float* t = *c1;
    *c1 = *c2;
    *c2 = t;
  }
  __syncthreads();
}

// Shared-memory rows of a net's saved layer inputs, seed excluded.
__host__ __device__ inline int hidden_rows(const Net& net) {
  int r = 0;
  for (int l = 1; l < net.n_layers; ++l) r += net.dims[l];
  return r;
}

// Layer-input pointers of a net whose seed lives at `seed` and whose hidden
// layers start at `base`.
__device__ inline void layer_inputs(const Net& net, float* seed, float* base,
                                    int rs, float** act) {
  act[0] = seed;
  for (int l = 1; l < net.n_layers; ++l) {
    act[l] = base;
    base += net.dims[l] * rs;
  }
}

int widest(const Net& net) {
  int w = 0;
  for (int l = 0; l <= net.n_layers; ++l) w = std::max(w, net.dims[l]);
  return w;
}

template <int S, bool DTT>
__global__ void __launch_bounds__(THREADS, 1)
mlp_jet_bwd_kernel(const float* __restrict__ seed_f,
                   const float* __restrict__ seed_d,
                   const float* __restrict__ seed_tt,
                   const float* __restrict__ cot, int n, Net net, Tile tl,
                   int cmax, int wmax, float* __restrict__ partial,
                   int n_params, int full_dx, float* __restrict__ dseed) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int e = net.dims[0];
  const int c_out = net.dims[net.n_layers];
  const int rs = tl.rs;
  float* seed = smem;
  float* hidden = seed + e * rs;
  float* c1 = hidden + hidden_rows(net) * rs;
  float* c2 = c1 + cmax * rs;
  float* ws = c2 + cmax * rs;
  float* bs = ws + round_up(wmax, 4);
  float* act[MAX_LAYERS];
  layer_inputs(net, seed, hidden, rs, act);
  float* g = partial + static_cast<size_t>(blockIdx.x) * n_params;

  const int tiles = (n + tl.T - 1) / tl.T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int n0 = tile * tl.T;
    const int nvalid = min(tl.T, n - n0);
    __syncthreads();  // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < S * tl.T * e; i += blockDim.x) {
      const int k = i % e;
      const int p = (i / e) % tl.T;
      const int s = i / (e * tl.T);
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
      seed[k * rs + s * tl.T + p] = v;
    }
    for (int i = threadIdx.x; i < S * tl.T * c_out; i += blockDim.x) {
      const int ch = i % c_out;
      const int p = (i / c_out) % tl.T;
      const int s = i / (c_out * tl.T);
      float v = 0.0f;
      if (p < nvalid)
        v = cot[(static_cast<size_t>(s) * n + n0 + p) * c_out + ch];
      c1[ch * rs + s * tl.T + p] = v;
    }

    remat_net<S, DTT>(net, act, ws, bs, tl);
    float* r1 = c1;
    float* r2 = c2;
    reverse_net<S, DTT>(net, act, &r1, &r2, ws, bs, g, first, tl);

    const int srows = full_dx ? S : 1;
    for (int i = threadIdx.x; i < srows * tl.T * e; i += blockDim.x) {
      const int k = i % e;
      const int p = (i / e) % tl.T;
      const int s = i / (e * tl.T);
      if (p < nvalid)
        dseed[(static_cast<size_t>(s) * n + n0 + p) * e + k] =
            r1[k * rs + s * tl.T + p];
    }
  }
}

template <int S, bool DTT>
__global__ void __launch_bounds__(THREADS, 1)
composite_jet_bwd_kernel(const float* __restrict__ xg, int n, int a,
                         Norm norm, Net nu, Net nd, Net np,
                         const float* __restrict__ cot, Tile tl, int cmax,
                         int wmax, float* __restrict__ partial, int n_params,
                         float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const int c_out = nu.dims[nu.n_layers];
  const int rs = tl.rs;
  float* seed = smem;
  float* hu = seed + a * rs;
  float* hd = hu + hidden_rows(nu) * rs;
  float* hp = hd + hidden_rows(nd) * rs;
  float* fu = hp + hidden_rows(np) * rs;   // uv output jet
  float* fd = fu + c_out * rs;             // dist output jet
  float* cu = fd + c_out * rs;             // uv output cotangent
  float* cd = cu + c_out * rs;             // dist output cotangent
  float* c1 = cd + c_out * rs;
  float* c2 = c1 + cmax * rs;
  float* ws = c2 + cmax * rs;
  float* bs = ws + round_up(wmax, 4);
  float* dxs = bs + round_up(cmax, 4);     // (a, T) summed seed cotangent
  float* act_u[MAX_LAYERS];
  float* act_d[MAX_LAYERS];
  float* act_p[MAX_LAYERS];
  layer_inputs(nu, seed, hu, rs, act_u);
  layer_inputs(nd, seed, hd, rs, act_d);
  layer_inputs(np, seed, hp, rs, act_p);
  float* gu = partial + static_cast<size_t>(blockIdx.x) * n_params;
  float* gd = gu + net_params(nu);
  float* gp = gd + net_params(nd);

  const int tiles = (n + tl.T - 1) / tl.T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int n0 = tile * tl.T;
    const int nvalid = min(tl.T, n - n0);
    __syncthreads();  // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < S * tl.T * a; i += blockDim.x) {
      const int k = i % a;
      const int p = (i / a) % tl.T;
      const int s = i / (a * tl.T);
      float v = 0.0f;
      if (s > 0 || p < nvalid)
        v = seed_value(norm, s, k, NT,
                       s == 0 ? xg[static_cast<size_t>(n0 + p) * a + k] : 0.0f);
      seed[k * rs + s * tl.T + p] = v;
    }
    for (int i = threadIdx.x; i < S * tl.T * c_out; i += blockDim.x) {
      const int ch = i % c_out;
      const int p = (i / c_out) % tl.T;
      const int s = i / (c_out * tl.T);
      float v = 0.0f;
      if (p < nvalid)
        v = cot[(static_cast<size_t>(s) * n + n0 + p) * c_out + ch];
      c1[ch * rs + s * tl.T + p] = v;
    }

    remat_net<S, DTT>(nu, act_u, ws, bs, tl);
    stage(nu, nu.n_layers - 1, ws, bs);
    forward_layer<S, DTT>(act_u[nu.n_layers - 1], nu.dims[nu.n_layers - 1],
                          c_out, ws, bs, fu, true, tl);
    remat_net<S, DTT>(nd, act_d, ws, bs, tl);
    stage(nd, nd.n_layers - 1, ws, bs);
    forward_layer<S, DTT>(act_d[nd.n_layers - 1], nd.dims[nd.n_layers - 1],
                          c_out, ws, bs, fd, true, tl);
    remat_net<S, DTT>(np, act_p, ws, bs, tl);
    __syncthreads();

    // Reverse of y = part + dist * uv (rows: value, tangents, dtt with
    // y_tt = p_tt + d_tt u + 2 d_t u_t + d u_tt).
    for (int i = threadIdx.x; i < c_out * tl.T; i += blockDim.x) {
      const int ch = i / tl.T;
      const int p = i % tl.T;
      const int r = ch * rs + p;
      const float u0 = fu[r];
      const float d0 = fd[r];
      const float c0 = c1[r];
      float acc_u = d0 * c0;
      float acc_d = u0 * c0;
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const int q = r + s * tl.T;
        const float cs = c1[q];
        acc_u += fd[q] * cs;
        acc_d += fu[q] * cs;
        cu[q] = d0 * cs;
        cd[q] = u0 * cs;
      }
      if (DTT) {
        const int t = r + NT * tl.T;
        const float ctt = c1[r + (S - 1) * tl.T];
        cu[t] += 2.0f * fd[t] * ctt;
        cd[t] += 2.0f * fu[t] * ctt;
      }
      cu[r] = acc_u;
      cd[r] = acc_d;
    }

    // part's cotangent is c itself.
    float* r1 = c1;
    float* r2 = c2;
    reverse_net<S, DTT>(np, act_p, &r1, &r2, ws, bs, gp, first, tl);
    for (int i = threadIdx.x; i < a * tl.T; i += blockDim.x)
      dxs[i] = r1[(i / tl.T) * rs + i % tl.T];
    for (int i = threadIdx.x; i < S * tl.T * c_out; i += blockDim.x) {
      const int ch = i / (S * tl.T);
      const int q = i % (S * tl.T);
      r2[ch * rs + q] = cu[ch * rs + q];
    }
    reverse_net<S, DTT>(nu, act_u, &r2, &r1, ws, bs, gu, first, tl);
    for (int i = threadIdx.x; i < a * tl.T; i += blockDim.x)
      dxs[i] += r2[(i / tl.T) * rs + i % tl.T];
    for (int i = threadIdx.x; i < S * tl.T * c_out; i += blockDim.x) {
      const int ch = i / (S * tl.T);
      const int q = i % (S * tl.T);
      r1[ch * rs + q] = cd[ch * rs + q];
    }
    reverse_net<S, DTT>(nd, act_d, &r1, &r2, ws, bs, gd, first, tl);
    for (int i = threadIdx.x; i < a * tl.T; i += blockDim.x) {
      const int k = i / tl.T;
      const int p = i % tl.T;
      if (p < nvalid)
        dx[static_cast<size_t>(n0 + p) * a + k] = dxs[i] + r1[k * rs + p];
    }
  }
}

// grad[i] = sum over blocks b, in order, of partial[b][i].
__global__ void reduce_partials(const float* __restrict__ partial, int blocks,
                                int n_params, float* __restrict__ grad) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_params;
       i += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < blocks; ++b)
      acc += partial[static_cast<size_t>(b) * n_params + i];
    grad[i] = acc;
  }
}

int launch_reduce(const float* partial, int blocks, int n_params, float* grad,
                  cudaStream_t stream) {
  const int grid = std::min(1024, (n_params + REDUCE_THREADS - 1) /
                                      REDUCE_THREADS);
  reduce_partials<<<grid, REDUCE_THREADS, 0, stream>>>(partial, blocks,
                                                       n_params, grad);
  return static_cast<int>(cudaGetLastError());
}

// Largest tile (8 or 4 points) whose buffers fit in shared memory; 0 if
// none does.  `rows` counts the shared rows of width RS, `extra` the floats
// outside them.
int pick_tile(int s, long rows, long extra, size_t* bytes) {
  for (int t = 8; t >= 4; t -= 4) {
    const long rs = static_cast<long>(s) * t + 4;
    const size_t b = static_cast<size_t>(rows * rs + extra) * sizeof(float);
    if (b <= static_cast<size_t>(MAX_SMEM)) {
      *bytes = b;
      return t;
    }
  }
  return 0;
}

int grid_blocks(int n, int t, int max_blocks) {
  const int tiles = (n + t - 1) / t;
  return std::max(1, std::min(tiles, max_blocks));
}

template <int S, bool DTT>
int launch_mlp_bwd(const float* sf, const float* sd, const float* stt,
                   const float* cot, int n, const Net& net, int full_dx,
                   int max_blocks, float* partial, float* grad, float* dseed,
                   cudaStream_t stream) {
  int hid = 0, wmax = 0, bmax = 0;
  net_sizes(net, &hid, &wmax, &bmax);
  const int cmax = widest(net);
  const long rows = net.dims[0] + hidden_rows(net) + 2L * cmax;
  size_t bytes = 0;
  const int t = pick_tile(S, rows, round_up(wmax, 4) + round_up(bmax, 4),
                          &bytes);
  if (t == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(mlp_jet_bwd_kernel<S, DTT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const Tile tl{t, S * t + 4};
  const int blocks = grid_blocks(n, t, max_blocks);
  const int n_params = static_cast<int>(net_params(net));
  mlp_jet_bwd_kernel<S, DTT><<<blocks, THREADS, bytes, stream>>>(
      sf, sd, stt, cot, n, net, tl, cmax, wmax, partial, n_params,
      full_dx, dseed);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(partial, blocks, n_params, grad, stream);
}

template <int S, bool DTT>
int launch_composite_bwd(const float* x, int n, int a, const Norm& norm,
                         const Net* nets, const float* cot, int max_blocks,
                         float* partial, float* grad, float* dx,
                         cudaStream_t stream) {
  int hid = 0, wmax = 0, bmax = 0;
  int cmax = 0;
  long rows = a;
  for (int i = 0; i < 3; ++i) {
    net_sizes(nets[i], &hid, &wmax, &bmax);
    cmax = std::max(cmax, widest(nets[i]));
    rows += hidden_rows(nets[i]);
  }
  const int c_out = nets[0].dims[nets[0].n_layers];
  rows += 4L * c_out + 2L * cmax;
  size_t bytes = 0;
  // ws, bs (cmax >= bmax) and the (a, T <= 8) seed-cotangent sum.
  const int t = pick_tile(S, rows, round_up(wmax, 4) + round_up(cmax, 4) +
                                       a * 8, &bytes);
  if (t == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(composite_jet_bwd_kernel<S, DTT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const Tile tl{t, S * t + 4};
  const int blocks = grid_blocks(n, t, max_blocks);
  const int n_params = static_cast<int>(
      net_params(nets[0]) + net_params(nets[1]) + net_params(nets[2]));
  composite_jet_bwd_kernel<S, DTT><<<blocks, THREADS, bytes, stream>>>(
      x, n, a, norm, nets[0], nets[1], nets[2], cot, tl, cmax, wmax, partial,
      n_params, dx);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(partial, blocks, n_params, grad, stream);
}

}  // namespace

extern "C" {

// seed_f: (n, E); seed_d: (A, n, E); seed_tt: (n, E) when order == 2; cot:
// (S, n, C) with S = 1 + A (+1 for order 2); packed/dims/n_layers as for
// fused_mlp_jet_launch; max_blocks: the most blocks to use (the SM count).
// partial: max_blocks x P floats of scratch, P the
// packed size; grad: P floats, the gradient in the packed layout; dseed:
// (S, n, E) when full_dx, else the value rows (n, E).
int fused_mlp_jet_bwd_launch(const float* seed_f, const float* seed_d,
                             const float* seed_tt, const float* cot, int n,
                             int n_tangents, int order, const float* packed,
                             const int* dims, int n_layers, int full_dx,
                             int max_blocks, float* partial, float* grad,
                             float* dseed, void* stream) {
  Net net;
  if (!make_net(packed, dims, n_layers, &net) || n < 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(
        grad, 0, net_params(net) * sizeof(float), st));
  const int key = n_tangents * 2 + (order == 2 ? 1 : 0);
  switch (key) {
    case 6: return launch_mlp_bwd<4, false>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, st);
    case 7: return launch_mlp_bwd<5, true>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, st);
    case 8: return launch_mlp_bwd<5, false>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, st);
    case 9: return launch_mlp_bwd<6, true>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (n, a) raw points; lb/ub: a floats each, or both null; the three nets
// as for fused_composite_jet_launch; cot: (S, n, C).  partial: max_blocks x
// (Pu + Pd + Pp) floats of scratch; grad: the uv, dist and part gradients,
// each in its packed layout, one after the other; dx: (n, a), the summed
// value-row seed cotangent (before the normalisation's chain rule).
int fused_composite_jet_bwd_launch(const float* x, int n, int a, int order,
                                   const float* lb, const float* ub,
                                   const float* pu, const int* du, int lu,
                                   const float* pd, const int* dd, int ld,
                                   const float* pp, const int* dp, int lp,
                                   const float* cot, int max_blocks,
                                   float* partial, float* grad, float* dx,
                                   void* stream) {
  Net nets[3];
  if (!make_net(pu, du, lu, &nets[0]) || !make_net(pd, dd, ld, &nets[1]) ||
      !make_net(pp, dp, lp, &nets[2]) || n < 0 || a < 3 || a > 4 ||
      max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = nets[0].dims[lu];
  for (int i = 0; i < 3; ++i)
    if (nets[i].dims[0] != a || nets[i].dims[nets[i].n_layers] != c)
      return static_cast<int>(cudaErrorInvalidValue);
  const Norm norm = make_norm(lb, ub, a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(
        grad, 0,
        (net_params(nets[0]) + net_params(nets[1]) + net_params(nets[2])) *
            sizeof(float),
        st));
  const int key = a * 2 + (order == 2 ? 1 : 0);
  switch (key) {
    case 6: return launch_composite_bwd<4, false>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, st);
    case 7: return launch_composite_bwd<5, true>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, st);
    case 8: return launch_composite_bwd<5, false>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, st);
    case 9: return launch_composite_bwd<6, true>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
