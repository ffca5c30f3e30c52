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
// Two tile designs.  mlp_jet_bwd_kernel uses the wide-tile design described
// before it below: 32-point tiles (16 or 8 for wider nets), the remat's
// saved activations in a per-block workspace in global memory (L2), three
// row buffers and two weight buffers in shared memory filled by cp.async
// while the previous layer runs, register-blocked products.
// composite_jet_bwd_kernel still keeps every layer's input for all S
// streams of the tile in shared memory: a buffer of width W is W rows of RS
// = S * T + 4 floats, element [k * RS + s * T + p] being feature k of stream
// s at point p.  For the three plate nets that is 723 rows, so T = 8 points
// per tile (T = 4 where 8 does not fit).  Its products give one thread one
// output feature for PG = 4 points of every stream (the forward kernels'
// item), so the tanh-jet epilogue and the reverse of it run in registers.
// In both, the z of the non-value streams is recomputed in the item that
// applies the reverse recurrence, so it is never stored.
//
// The launchers take device pointers, sizes and a cudaStream_t, launch the
// main kernel and the reduction on that stream without synchronising, and
// return cudaGetLastError().  They are instantiated for 3 or 4 input
// coordinates, order 1 or 2; anything else, or a net too wide for shared
// memory at the smallest tile, returns cudaErrorInvalidValue.

#include "jet_common.cuh"

namespace {

constexpr int PG = 4;            // points per thread item (one float4)
constexpr int THREADS = 256;     // composite_jet_bwd_kernel
constexpr int REDUCE_THREADS = 256;

// From here to composite_jet_bwd_kernel, apart from packed_offsets: the
// 8-point design's helpers, which only that kernel uses.
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

// ---------------------------------------------------------------------------
// The wide-tile design of mlp_jet_bwd_kernel (B2, B3b).
//
// A tile is 32 points (16 or 8 where 32 does not fit), and shared memory
// holds only the layers in flight.  The remat writes every hidden layer's
// output act[m] (m = 1 .. L-1, all S streams, rows of RS = S * T + 4 floats
// as above) to a per-block workspace in global memory, which stays in L2;
// the seed act[0] is not saved, since it is the kernel's input.  Three row
// buffers take the activations and cotangents in turn: act[m] lives in
// buffer slot(m), and when the reverse sweep is done with it, the same
// buffer receives act[m]'s cotangent.  The head's output cotangent is the
// cotangent of "act[L]".  So at reverse layer l the input act[l] is in
// slot(l), the output cotangent in slot(l + 1), and slot(l - 1) is free:
// while layer l runs, act[l - 1] is copied into it from the workspace (or
// from the seed) with cp.async, and layer l - 1's weights into the second
// of two weight buffers (a net too wide for two, such as a 140-wide one,
// gets one, and each layer's weights are copied when the layer starts).
// The remat overlaps the next layer's weights the same way.  The launcher
// takes the largest tile that fits, with two weight buffers where they
// fit.  The input cotangent overwrites act[l] in place
// once the weight gradient has read it; layer 0 writes the seed cotangent
// straight to dseed.  The value row h of a layer's output, which the
// reverse epilogue needs, is read from the workspace.
//
// Products are register blocked: an item computes FB output features for P
// points of every stream (FB * P * S accumulators), so each float4 of
// activations it loads from shared memory (shared by the lanes of a warp,
// which differ in the feature) feeds FB * 4 FMAs; the weight gradient
// blocks KB rows by JB columns.  The block has as many threads as a hidden
// layer has items (288 at 70 features and 32 points), up to 512.
namespace wide {

constexpr int P = 4;     // points per item (one float4)
constexpr int FB = 2;    // output features per product item
constexpr int KB = 5;    // weight-gradient rows per item
constexpr int JB = 4;    // weight-gradient columns per item
constexpr int MAX_THREADS = 512;

// Shared-memory and workspace layout of one launch (floats).
struct Layout {
  int T;          // points per tile
  int rs;         // row stride, S * T + 4
  int buf[3];     // offsets of the three row buffers
  int wbuf[2];    // offsets of the weight buffers; equal with one buffer
  int threads;
  long ws_floats;  // workspace per block
};

// The row buffer of act[m] in a net of L layers.
__host__ __device__ inline int slot(int m, int L) {
  return ((m + 1 - L) % 3 + 3) % 3;
}

// Layer l's W (fi x fo) then b, at round_up(fi * fo, 4), into w.
__device__ void stage_weights(const Net& net, int l, float* w) {
  const int n_w = net.dims[l] * net.dims[l + 1];
  float* b = w + round_up(n_w, 4);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x)
    copy_async4(w + i, net.w[l] + i);
  for (int i = threadIdx.x; i < net.dims[l + 1]; i += blockDim.x)
    copy_async4(b + i, net.b[l] + i);
}

// The seed streams of points n0 .. n0 + nvalid - 1 into rows of width e;
// zeros past the last point.
template <int S, bool DTT, int T>
__device__ void gather_seed(const float* seed_f, const float* seed_d,
                            const float* seed_tt, int n, int n0, int nvalid,
                            int e, int rs, float* dst) {
  for (int i = threadIdx.x; i < S * T * e; i += blockDim.x) {
    const int k = i % e;
    const int p = (i / e) % T;
    const int s = i / (e * T);
    float* d = dst + k * rs + s * T + p;
    if (p >= nvalid) {
      *d = 0.0f;
      continue;
    }
    const size_t pt = static_cast<size_t>(n0 + p) * e + k;
    const float* src =
        s == 0                ? seed_f + pt
        : (DTT && s == S - 1) ? seed_tt + pt
                              : seed_d + static_cast<size_t>(s - 1) * n * e + pt;
    copy_async4(d, src);
  }
}

// The output cotangent (S, n, c) of the tile into rows of width c.
template <int S, int T>
__device__ void gather_cot(const float* cot, int n, int n0, int nvalid,
                           int c, int rs, float* dst) {
  for (int i = threadIdx.x; i < S * T * c; i += blockDim.x) {
    const int ch = i % c;
    const int p = (i / c) % T;
    const int s = i / (c * T);
    float* d = dst + ch * rs + s * T + p;
    if (p < nvalid)
      copy_async4(d, cot + (static_cast<size_t>(s) * n + n0 + p) * c + ch);
    else
      *d = 0.0f;
  }
}

// `floats` (a multiple of 4) contiguous floats from the workspace.
__device__ void copy_rows(float* dst, const float* src, int floats) {
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * blockDim.x)
    copy_async16(dst + i, src + i);
}

// Start layer l: make its weights resident, wait for every copy in flight,
// and, with two weight buffers, start copying layer `next`'s weights.
// `held` tracks which layer each buffer holds (the same in every thread).
__device__ const float* begin_layer(const Net& net, int l, int next,
                                    const Layout& lay, float* smem,
                                    int* held) {
  const bool two = lay.wbuf[0] != lay.wbuf[1];
  const int b = two ? (l & 1) : 0;
  if (held[b] != l) {
    __syncthreads();  // every reader of the buffer's layer is done
    stage_weights(net, l, smem + lay.wbuf[b]);
    held[b] = l;
  }
  copy_async_commit();
  copy_async_wait();
  __syncthreads();
  if (two && next >= 0 && held[next & 1] != next) {
    stage_weights(net, next, smem + lay.wbuf[next & 1]);
    held[next & 1] = next;
  }
  return smem + lay.wbuf[b];
}

// Remat of hidden layer l: out = layer(in) into shared memory and into the
// workspace (out_g).
template <int S, bool DTT, int T>
__device__ void forward_layer(const float* in, int fi, int fo,
                              const float* ws, float* out, float* out_g,
                              int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const float* bs = ws + round_up(fi * fo, 4);
  const int groups = (fo + FB - 1) / FB;
  const int items = groups * (T / P);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q0 = (it / groups) * P;
    int jc[FB];
#pragma unroll
    for (int m = 0; m < FB; ++m)
      jc[m] = min(it % groups + m * groups, fo - 1);  // clamped; not stored
    float acc[FB][S][P];
#pragma unroll
    for (int m = 0; m < FB; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[m][s][q] = 0.0f;
    const float* row = in + q0;
#pragma unroll 2
    for (int k = 0; k < fi; ++k, row += rs) {
      float w[FB];
#pragma unroll
      for (int m = 0; m < FB; ++m) w[m] = ws[k * fo + jc[m]];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * T);
#pragma unroll
        for (int m = 0; m < FB; ++m) {
          acc[m][s][0] = fmaf(a.x, w[m], acc[m][s][0]);
          acc[m][s][1] = fmaf(a.y, w[m], acc[m][s][1]);
          acc[m][s][2] = fmaf(a.z, w[m], acc[m][s][2]);
          acc[m][s][3] = fmaf(a.w, w[m], acc[m][s][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < FB; ++m) {
      const int j = it % groups + m * groups;
      if (j >= fo) continue;
      const float bj = bs[j];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float h = tanhf(acc[m][0][q] + bj);
        const float g = 1.0f - h * h;
        if (DTT) {
          const float zt = acc[m][NT][q];
          acc[m][S - 1][q] = g * acc[m][S - 1][q] - 2.0f * h * g * (zt * zt);
        }
#pragma unroll
        for (int s = 1; s <= NT; ++s) acc[m][s][q] *= g;
        acc[m][0][q] = h;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 v = make_float4(acc[m][s][0], acc[m][s][1],
                                     acc[m][s][2], acc[m][s][3]);
        const int off = j * rs + s * T + q0;
        *reinterpret_cast<float4*>(out + off) = v;
        *reinterpret_cast<float4*>(out_g + off) = v;
      }
    }
  }
}

// Reverse of a hidden layer's tanh-jet epilogue, in place on c (width fo);
// z of the non-value streams is recomputed from s_in, h read from h_g
// (the layer's saved output in the workspace).
template <int S, bool DTT, int T>
__device__ void reverse_epilogue(float* c, const float* s_in,
                                 const float* h_g, int fi, int fo,
                                 const float* ws, int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const int groups = (fo + FB - 1) / FB;
  const int items = groups * (T / P);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q0 = (it / groups) * P;
    int jc[FB];
    float4 h4[FB];
#pragma unroll
    for (int m = 0; m < FB; ++m) {
      jc[m] = min(it % groups + m * groups, fo - 1);
      h4[m] = load_cg(reinterpret_cast<const float4*>(h_g + jc[m] * rs + q0));
    }
    float z[FB][S][P];  // z[.][0] unused: the value stream needs no recompute
#pragma unroll
    for (int m = 0; m < FB; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q) z[m][s][q] = 0.0f;
    const float* row = s_in + q0;
#pragma unroll 2
    for (int k = 0; k < fi; ++k, row += rs) {
      float w[FB];
#pragma unroll
      for (int m = 0; m < FB; ++m) w[m] = ws[k * fo + jc[m]];
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * T);
#pragma unroll
        for (int m = 0; m < FB; ++m) {
          z[m][s][0] = fmaf(a.x, w[m], z[m][s][0]);
          z[m][s][1] = fmaf(a.y, w[m], z[m][s][1]);
          z[m][s][2] = fmaf(a.z, w[m], z[m][s][2]);
          z[m][s][3] = fmaf(a.w, w[m], z[m][s][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < FB; ++m) {
      const int j = it % groups + m * groups;
      if (j >= fo) continue;
      float* col = c + j * rs + q0;
      const float hv[P] = {h4[m].x, h4[m].y, h4[m].z, h4[m].w};
      float cv[S][P];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(col + s * T);
        cv[s][0] = v.x;
        cv[s][1] = v.y;
        cv[s][2] = v.z;
        cv[s][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float h = hv[q];
        const float g = 1.0f - h * h;
        float acc = 0.0f;
#pragma unroll
        for (int t = 1; t <= NT; ++t) acc += cv[t][q] * z[m][t][q];
        float chh = cv[0][q] - 2.0f * h * acc;
        float ct[S];
#pragma unroll
        for (int t = 1; t <= NT; ++t) ct[t] = g * cv[t][q];
        if (DTT) {
          const float zt = z[m][NT][q];
          const float ztt = z[m][S - 1][q];
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
        *reinterpret_cast<float4*>(col + s * T) =
            make_float4(cv[s][0], cv[s][1], cv[s][2], cv[s][3]);
    }
  }
}

// The tile's dW = s_in^T c over every stream and db = the value rows of c,
// stored into (first tile of the block) or added to the block's partial.
// An item owns KB consecutive rows k and JB columns j strided by the
// number of column groups, so the lanes of a warp share the rows of s_in
// and read neighbouring rows of c.
template <int S, int T>
__device__ void accumulate_grads(const float* s_in, int fi, const float* c,
                                 int fo, float* gw, float* gb, bool first,
                                 int rs) {
  const int jgroups = (fo + JB - 1) / JB;
  const int items = (fi + KB - 1) / KB * jgroups;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int jg = e % jgroups;
    const int k0 = (e / jgroups) * KB;
    const float* a[KB];
    const float* b[JB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) a[kk] = s_in + min(k0 + kk, fi - 1) * rs;
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      b[jj] = c + min(jg + jj * jgroups, fo - 1) * rs;
    float acc[KB][JB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) acc[kk][jj] = 0.0f;
    for (int r = 0; r < S * T; r += 4) {
      float4 y[JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        y[jj] = *reinterpret_cast<const float4*>(b[jj] + r);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(a[kk] + r);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          acc[kk][jj] = fmaf(x.x, y[jj].x, acc[kk][jj]);
          acc[kk][jj] = fmaf(x.y, y[jj].y, acc[kk][jj]);
          acc[kk][jj] = fmaf(x.z, y[jj].z, acc[kk][jj]);
          acc[kk][jj] = fmaf(x.w, y[jj].w, acc[kk][jj]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int k = k0 + kk;
        const int j = jg + jj * jgroups;
        if (k < fi && j < fo) {
          float* w = gw + k * fo + j;
          *w = first ? acc[kk][jj] : *w + acc[kk][jj];
        }
      }
  }
  for (int j = threadIdx.x; j < fo; j += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < T; ++p) acc += c[j * rs + p];
    gb[j] = first ? acc : gb[j] + acc;
  }
}

// c_in = c W^T, the cotangent of the layer's input (width fi), into the
// rows `out`; or, with out null, the first `srows` streams of the valid
// points straight into the seed cotangent dseed (S, n, fi).
template <int S, int T>
__device__ void backward_product(const float* c, int fo, const float* ws,
                                 int fi, float* out, int rs, float* dseed,
                                 int n, int n0, int nvalid, int srows) {
  const int groups = (fi + FB - 1) / FB;
  const int items = groups * (T / P);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q0 = (it / groups) * P;
    const float* wr[FB];
#pragma unroll
    for (int m = 0; m < FB; ++m)
      wr[m] = ws + min(it % groups + m * groups, fi - 1) * fo;
    float acc[FB][S][P];
#pragma unroll
    for (int m = 0; m < FB; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[m][s][q] = 0.0f;
    const float* row = c + q0;
#pragma unroll 2
    for (int j = 0; j < fo; ++j, row += rs) {
      float w[FB];
#pragma unroll
      for (int m = 0; m < FB; ++m) w[m] = wr[m][j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * T);
#pragma unroll
        for (int m = 0; m < FB; ++m) {
          acc[m][s][0] = fmaf(a.x, w[m], acc[m][s][0]);
          acc[m][s][1] = fmaf(a.y, w[m], acc[m][s][1]);
          acc[m][s][2] = fmaf(a.z, w[m], acc[m][s][2]);
          acc[m][s][3] = fmaf(a.w, w[m], acc[m][s][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < FB; ++m) {
      const int k = it % groups + m * groups;
      if (k >= fi) continue;
      if (out != nullptr) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          *reinterpret_cast<float4*>(out + k * rs + s * T + q0) =
              make_float4(acc[m][s][0], acc[m][s][1], acc[m][s][2],
                          acc[m][s][3]);
        continue;
      }
      for (int s = 0; s < srows; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (q0 + q < nvalid)
            dseed[(static_cast<size_t>(s) * n + n0 + q0 + q) * fi + k] =
                acc[m][s][q];
    }
  }
}

}  // namespace wide

template <int S, bool DTT, int T>
__global__ void __launch_bounds__(wide::MAX_THREADS, 1)
mlp_jet_bwd_kernel(const float* __restrict__ seed_f,
                   const float* __restrict__ seed_d,
                   const float* __restrict__ seed_tt,
                   const float* __restrict__ cot, int n, Net net,
                   wide::Layout lay, float* __restrict__ partial,
                   int n_params, int full_dx, float* __restrict__ dseed,
                   float* workspace) {
  using namespace wide;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = net.n_layers;
  const int e = net.dims[0];
  const int rs = lay.rs;
  float* g = partial + static_cast<size_t>(blockIdx.x) * n_params;
  float* wact[MAX_LAYERS];  // act[m], m >= 1, in this block's workspace
  float* wp = workspace + static_cast<size_t>(blockIdx.x) * lay.ws_floats;
  for (int m = 1; m < L; ++m) {
    wact[m] = wp;
    wp += static_cast<size_t>(net.dims[m]) * rs;
  }
  auto rows = [&](int m) { return smem + lay.buf[slot(m, L)]; };
  int held[2] = {-1, -1};

  const int tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int n0 = tile * T;
    const int nvalid = min(T, n - n0);
    __syncthreads();  // the previous tile is done with shared memory
    gather_seed<S, DTT, T>(seed_f, seed_d, seed_tt, n, n0, nvalid, e, rs,
                           rows(0));
    if (L == 1) gather_cot<S, T>(cot, n, n0, nvalid, net.dims[1], rs, rows(1));

    for (int l = 0; l + 1 < L; ++l) {
      const float* ws = begin_layer(net, l, l + 1, lay, smem, held);
      if (l + 2 == L)  // slot(L) is free once layer L - 3 has run
        gather_cot<S, T>(cot, n, n0, nvalid, net.dims[L], rs, rows(L));
      copy_async_commit();
      forward_layer<S, DTT, T>(rows(l), net.dims[l], net.dims[l + 1], ws,
                               rows(l + 1), wact[l + 1], rs);
    }

    for (int l = L - 1; l >= 0; --l) {
      const int fi = net.dims[l];
      const int fo = net.dims[l + 1];
      const float* ws = begin_layer(net, l, l - 1, lay, smem, held);
      if (l >= 1 && l + 1 < L) {  // act[L - 2] is still resident
        if (l == 1)
          gather_seed<S, DTT, T>(seed_f, seed_d, seed_tt, n, n0, nvalid, e,
                                 rs, rows(0));
        else
          copy_rows(rows(l - 1), wact[l - 1], net.dims[l - 1] * rs);
      }
      copy_async_commit();
      float* s_in = rows(l);
      float* c = rows(l + 1);
      if (l + 1 < L) {
        reverse_epilogue<S, DTT, T>(c, s_in, wact[l + 1], fi, fo, ws, rs);
        __syncthreads();
      }
      int w_off, b_off;
      packed_offsets(net, l, &w_off, &b_off);
      accumulate_grads<S, T>(s_in, fi, c, fo, g + w_off, g + b_off, first,
                             rs);
      if (l > 0) {
        __syncthreads();  // the weight gradient is done with s_in
        backward_product<S, T>(c, fo, ws, fi, s_in, rs, nullptr, n, n0,
                               nvalid, 0);
      } else {
        backward_product<S, T>(c, fo, ws, fi, nullptr, rs, dseed, n, n0,
                               nvalid, full_dx ? S : 1);
      }
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

int grid_blocks(int n, int t, int max_blocks) {
  const int tiles = (n + t - 1) / t;
  return std::max(1, std::min(tiles, max_blocks));
}

// The wide-tile layout of a net: row buffers sized by what each slot
// holds, one or two weight buffers; returns the shared floats it needs.
long wide_plan(const Net& net, int s, int t, bool two, wide::Layout* lay) {
  const int L = net.n_layers;
  lay->T = t;
  lay->rs = s * t + 4;
  int rows[3] = {0, 0, 0};
  for (int m = 0; m <= L; ++m) {
    int& r = rows[wide::slot(m, L)];
    r = std::max(r, net.dims[m]);
  }
  long off = 0;
  for (int b = 0; b < 3; ++b) {
    lay->buf[b] = static_cast<int>(off);
    off += static_cast<long>(rows[b]) * lay->rs;
  }
  long wsize[2] = {0, 0};
  for (int l = 0; l < L; ++l) {
    long& w = wsize[two ? (l & 1) : 0];
    w = std::max(w, static_cast<long>(round_up(net.dims[l] * net.dims[l + 1], 4) +
                                      round_up(net.dims[l + 1], 4)));
  }
  lay->wbuf[0] = static_cast<int>(off);
  off += wsize[0];
  lay->wbuf[1] = two ? static_cast<int>(off) : lay->wbuf[0];
  off += wsize[1];
  long hidden = 0;
  for (int m = 1; m < L; ++m) hidden += net.dims[m];
  lay->ws_floats = hidden * lay->rs;
  // One item per FB features and P points of the widest hidden layer.
  int widest_hidden = L == 1 ? std::max(net.dims[0], net.dims[1]) : 0;
  for (int m = 1; m < L; ++m) widest_hidden = std::max(widest_hidden, net.dims[m]);
  const int items = (widest_hidden + wide::FB - 1) / wide::FB * (t / wide::P);
  lay->threads = std::min(wide::MAX_THREADS, std::max(64, round_up(items, 32)));
  return off;
}

// The largest tile (32, 16 or 8 points) that fits, with two weight buffers
// where they fit; returns the shared bytes, 0 if nothing fits.
size_t wide_layout(const Net& net, int s, wide::Layout* lay) {
  for (int t = 32; t >= 8; t /= 2)
    for (int two = 1; two >= 0; --two) {
      const size_t bytes = wide_plan(net, s, t, two == 1, lay) * sizeof(float);
      if (bytes <= static_cast<size_t>(MAX_SMEM)) return bytes;
    }
  return 0;
}

template <int S, bool DTT>
int launch_mlp_bwd(const float* sf, const float* sd, const float* stt,
                   const float* cot, int n, const Net& net, int full_dx,
                   int max_blocks, float* partial, float* grad, float* dseed,
                   float* workspace, cudaStream_t stream) {
  wide::Layout lay;
  const size_t bytes = wide_layout(net, S, &lay);
  if (bytes == 0 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = lay.T == 32   ? mlp_jet_bwd_kernel<S, DTT, 32>
                    : lay.T == 16 ? mlp_jet_bwd_kernel<S, DTT, 16>
                                  : mlp_jet_bwd_kernel<S, DTT, 8>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int blocks = grid_blocks(n, lay.T, max_blocks);
  const int n_params = static_cast<int>(net_params(net));
  kern<<<blocks, lay.threads, bytes, stream>>>(
      sf, sd, stt, cot, n, net, lay, partial, n_params, full_dx, dseed,
      workspace);
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
                                       a * 8, 8, 4, &bytes);
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

// Floats of workspace that fused_mlp_jet_bwd_launch needs per block for a
// net of these widths; -1 if the kernel does not take it.
long long fused_mlp_jet_bwd_workspace(int n_tangents, int order,
                                      const int* dims, int n_layers) {
  if (n_tangents < 3 || n_tangents > 4 || order < 1 || order > 2 ||
      n_layers < 1 || n_layers > MAX_LAYERS)
    return -1;
  Net net;  // widths only: the layout does not read the parameters
  net.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return -1;
    net.dims[l] = dims[l];
  }
  wide::Layout lay;
  if (wide_layout(net, 1 + n_tangents + (order == 2 ? 1 : 0), &lay) == 0)
    return -1;
  return lay.ws_floats;
}

// seed_f: (n, E); seed_d: (A, n, E); seed_tt: (n, E) when order == 2; cot:
// (S, n, C) with S = 1 + A (+1 for order 2); packed/dims/n_layers as for
// fused_mlp_jet_launch; max_blocks: the most blocks to use (the SM count).
// partial: max_blocks x P floats of scratch, P the
// packed size; grad: P floats, the gradient in the packed layout; dseed:
// (S, n, E) when full_dx, else the value rows (n, E); workspace: max_blocks
// x fused_mlp_jet_bwd_workspace(...) floats of scratch.
int fused_mlp_jet_bwd_launch(const float* seed_f, const float* seed_d,
                             const float* seed_tt, const float* cot, int n,
                             int n_tangents, int order, const float* packed,
                             const int* dims, int n_layers, int full_dx,
                             int max_blocks, float* partial, float* grad,
                             float* dseed, float* workspace, void* stream) {
  Net net;
  if (!make_net(packed, dims, n_layers, &net) || n < 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(
        grad, 0, net_params(net) * sizeof(float), st));
  const int key = n_tangents * 2 + (order == 2 ? 1 : 0);
  switch (key) {
    case 6: return launch_mlp_bwd<4, false>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, workspace, st);
    case 7: return launch_mlp_bwd<5, true>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, workspace, st);
    case 8: return launch_mlp_bwd<5, false>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, workspace, st);
    case 9: return launch_mlp_bwd<6, true>(seed_f, seed_d, seed_tt, cot, n, net, full_dx, max_blocks, partial, grad, dseed, workspace, st);
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
