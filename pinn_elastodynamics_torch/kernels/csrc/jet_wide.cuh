// The wide-tile layer of the fused-jet kernels: the device functions that
// run one net's forward jet over a tile of points, shared by the forward
// kernels (fused_jet.cu: mlp_jet_kernel, composite_jet_kernel) and the
// backward kernels (fused_jet_vjp.cu: mlp_jet_bwd_kernel, whose remat they
// are, and composite_jet_bwd_kernel), and the host-side plan of a launch.
//
// A tile is T points, the first of the launch's tiles that fits (32, 16 or
// 8 for the backward).  A buffer of width W is W rows of RS = S * T + 4
// floats, element [k * RS + s * T + p] being feature k of stream s at point
// p; the 4-float pad spreads neighbouring rows over the banks.  Row buffers
// take a net's layer outputs in turn, act[m] in row_buffer<NB>(m): three
// for the backward (slot(m), so act[m - 1], act[m] and act[m + 1] never
// share one), two for the forward, which keeps no layer past the next.  Two
// weight buffers (one for a net too wide for two) hold a layer's W and b:
// begin_layer makes layer l resident and starts the cp.async copy of the
// next layer's into the other buffer while layer l runs.
//
// A layer's product is register blocked: an item computes F output features
// for P = 4 points of every stream (F * P * S accumulators), each as the
// sequential fmaf chain over the layer's inputs, so each float4 of
// activations it loads from shared memory (the lanes of a warp share the
// points and differ in the feature) feeds F * 4 FMAs.  A layer whose
// one-feature items fit the block's threads in one round takes those
// instead (narrow); which thread computes an element does not change its
// arithmetic, so the results are the same either way.  The block has one
// thread per item of its widest hidden layer, at most the launch's bound
// (MAX_THREADS for the backward).  F, NB, the tiles and the bound are
// template arguments or plan parameters whose defaults are the backward's.

#pragma once

#include "jet_common.cuh"

namespace {
namespace wide {

constexpr int P = 4;     // points per item (one float4)
constexpr int FB = 2;    // output features per product item
constexpr int MAX_THREADS = 512;

// Shared-memory and workspace layout of one launch (floats).
struct Layout {
  int T;          // points per tile
  int rs;         // row stride, S * T + 4
  int buf[3];     // offsets of the three row buffers
  int wbuf[2];    // offsets of the weight buffers; equal with one buffer
  int extra;      // offset of the kernel's own buffers, after the weights
  int threads;
  long ws_floats;  // workspace per block
};

// The row buffer of act[m] in a net of L layers.
__host__ __device__ inline int slot(int m, int L) {
  return ((m + 1 - L) % 3 + 3) % 3;
}

// The row buffer of act[m] with NB buffers: three in turn (slot), or, for
// a forward that keeps no layer past the next, two in turn.
template <int NB>
__host__ __device__ inline int row_buffer(int m, int L) {
  return NB == 3 ? slot(m, L) : (m & 1);
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


// Start layer l of net `id`: make its weights resident, wait for every copy
// in flight, and, with two weight buffers, start copying layer `next`'s
// weights of the same net.  `held` records which (net, layer) each buffer
// holds (the same in every thread), so a kernel that runs several nets in
// turn never reads another net's layer of the same index.
__device__ const float* begin_layer(const Net& net, int id, int l, int next,
                                    const Layout& lay, float* smem,
                                    int* held) {
  const bool two = lay.wbuf[0] != lay.wbuf[1];
  const int b = two ? (l & 1) : 0;
  if (held[b] != id * MAX_LAYERS + l) {
    __syncthreads();  // every reader of the buffer's layer is done
    stage_weights(net, l, smem + lay.wbuf[b]);
    held[b] = id * MAX_LAYERS + l;
  }
  copy_async_commit();
  copy_async_wait();
  __syncthreads();
  if (two && next >= 0 && held[next & 1] != id * MAX_LAYERS + next) {
    stage_weights(net, next, smem + lay.wbuf[next & 1]);
    held[next & 1] = id * MAX_LAYERS + next;
  }
  return smem + lay.wbuf[b];
}

// out = layer(in) into shared memory and, unless out_g is null, into the
// workspace: the jet of a hidden tanh layer, or with HEAD the linear head
// (bias on the value rows only).  F output features per item.
template <int S, bool DTT, int T, bool HEAD, int F>
__device__ void forward_layer(const float* in, int fi, int fo,
                              const float* ws, float* out, float* out_g,
                              int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const float* bs = ws + round_up(fi * fo, 4);
  const int groups = (fo + F - 1) / F;
  const int items = groups * (T / P);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q0 = (it / groups) * P;
    int jc[F];
#pragma unroll
    for (int m = 0; m < F; ++m)
      jc[m] = min(it % groups + m * groups, fo - 1);  // clamped; not stored
    float acc[F][S][P];
#pragma unroll
    for (int m = 0; m < F; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[m][s][q] = 0.0f;
    const float* row = in + q0;
#pragma unroll 2
    for (int k = 0; k < fi; ++k, row += rs) {
      float w[F];
#pragma unroll
      for (int m = 0; m < F; ++m) w[m] = ws[k * fo + jc[m]];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * T);
#pragma unroll
        for (int m = 0; m < F; ++m) {
          acc[m][s][0] = fmaf(a.x, w[m], acc[m][s][0]);
          acc[m][s][1] = fmaf(a.y, w[m], acc[m][s][1]);
          acc[m][s][2] = fmaf(a.z, w[m], acc[m][s][2]);
          acc[m][s][3] = fmaf(a.w, w[m], acc[m][s][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < F; ++m) {
      const int j = it % groups + m * groups;
      if (j >= fo) continue;
      const float bj = bs[j];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (HEAD) {
          acc[m][0][q] += bj;
          continue;
        }
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
        if (out_g != nullptr) *reinterpret_cast<float4*>(out_g + off) = v;
      }
    }
  }
}

// A layer `width` features wide whose items of several features would leave
// most of the block's `threads` idle takes one feature per item.  Which
// thread computes an element does not change its arithmetic, so the results
// are the same.  (`threads` is the launch's, not blockDim.x, so that the
// one-thread CPU emulation takes the same paths.)
__device__ inline bool narrow(int width, int T, int threads) {
  return width * (T / P) <= threads;
}

template <int S, bool DTT, int T, bool HEAD, int F = FB>
__device__ void forward_any(const float* in, int fi, int fo, const float* ws,
                            float* out, float* out_g, int rs, int threads) {
  if (narrow(fo, T, threads))
    forward_layer<S, DTT, T, HEAD, 1>(in, fi, fo, ws, out, out_g, rs);
  else
    forward_layer<S, DTT, T, HEAD, F>(in, fi, fo, ws, out, out_g, rs);
}

// Remat of net `id`'s hidden layers on one tile: act[m] (m = 1 .. L-1) into
// the row buffers and, unless `save` is null, into the workspace rows at
// `save`.  fill_seed(rows) returns where the seed streams act[0] are: it
// may put them into act[0]'s row buffer `rows`, or return a buffer of its
// own.  place_cot(rows) is called once the head cotangent's buffer slot(L)
// is free (before the first layer of a one-layer net, else with layer
// L - 2), so that copies into it overlap the last layer.  Returns act[0].
template <int S, bool DTT, int T, int F = FB, int NB = 3, class Seed,
          class Cot>
__device__ const float* remat_net(const Net& net, int id, const Layout& lay,
                                  float* smem, int* held, float* save,
                                  Seed fill_seed, Cot place_cot) {
  const int L = net.n_layers;
  auto rows = [&](int m) { return smem + lay.buf[row_buffer<NB>(m, L)]; };
  const float* s0 = fill_seed(rows(0));
  if (L == 1) place_cot(rows(1));
  float* out_g = save;
  for (int l = 0; l + 1 < L; ++l) {
    const float* ws = begin_layer(net, id, l, l + 1, lay, smem, held);
    if (l + 2 == L) place_cot(rows(L));
    copy_async_commit();
    forward_any<S, DTT, T, false, F>(l == 0 ? s0 : rows(l), net.dims[l],
                                  net.dims[l + 1], ws, rows(l + 1), out_g,
                                  lay.rs, lay.threads);
    if (out_g != nullptr) out_g += net.dims[l + 1] * lay.rs;
  }
  return s0;
}

// The linear head of a rematerialised net, whose act[0] is s0: its output
// jet into `out` (width dims[L], row stride rs).
template <int S, bool DTT, int T, int F = FB, int NB = 3>
__device__ void head_forward(const Net& net, int id, const Layout& lay,
                             float* smem, int* held, const float* s0,
                             float* out) {
  const int L = net.n_layers;
  const float* ws = begin_layer(net, id, L - 1, -1, lay, smem, held);
  forward_any<S, DTT, T, true, F>(
      L == 1 ? s0 : smem + lay.buf[row_buffer<NB>(L - 1, L)], net.dims[L - 1],
      net.dims[L], ws, out, nullptr, lay.rs, lay.threads);
}

}  // namespace wide

// The wide-tile layout of `count` nets that take turns on a tile: `nbuf`
// row buffers sized by what each holds in any of them, one or two weight
// buffers, then the kernel's own `extra_rows` rows and `extra_cols` floats
// per point; the workspace holds the most hidden rows of any one net.
// Returns the shared floats it needs.
long wide_plan(const Net* nets, int count, int s, int t, bool two,
               int extra_rows, int extra_cols, wide::Layout* lay,
               int fb = wide::FB, int nbuf = 3,
               int max_threads = wide::MAX_THREADS) {
  lay->T = t;
  lay->rs = s * t + 4;
  int rows[3] = {0, 0, 0};
  long wsize[2] = {0, 0};
  long hidden = 0;
  int widest_hidden = 0;  // one item per fb features and P points of it
  for (int i = 0; i < count; ++i) {
    const Net& net = nets[i];
    const int L = net.n_layers;
    for (int m = 0; m <= L; ++m) {
      int& r = rows[nbuf == 3 ? wide::slot(m, L) : (m & 1)];
      r = std::max(r, net.dims[m]);
    }
    for (int l = 0; l < L; ++l) {
      long& w = wsize[two ? (l & 1) : 0];
      w = std::max(w, static_cast<long>(round_up(net.dims[l] * net.dims[l + 1], 4) +
                                        round_up(net.dims[l + 1], 4)));
    }
    long h = 0;
    int widest = L == 1 ? std::max(net.dims[0], net.dims[1]) : 0;
    for (int m = 1; m < L; ++m) {
      h += net.dims[m];
      widest = std::max(widest, net.dims[m]);
    }
    hidden = std::max(hidden, h);
    widest_hidden = std::max(widest_hidden, widest);
  }
  long off = 0;
  for (int b = 0; b < 3; ++b) {
    lay->buf[b] = static_cast<int>(off);
    off += static_cast<long>(rows[b]) * lay->rs;
  }
  lay->wbuf[0] = static_cast<int>(off);
  off += wsize[0];
  lay->wbuf[1] = two ? static_cast<int>(off) : lay->wbuf[0];
  off += wsize[1];
  lay->extra = static_cast<int>(off);
  off += static_cast<long>(extra_rows) * lay->rs + static_cast<long>(extra_cols) * t;
  lay->ws_floats = hidden * lay->rs;
  const int items = (widest_hidden + fb - 1) / fb * (t / wide::P);
  lay->threads = std::min(max_threads, std::max(64, round_up(items, 32)));
  return off;
}

// The tiles a launch may take, largest first, ending in 0.
constexpr int WIDE_TILES[] = {32, 16, 8, 0};

// The first of `tiles` that fits, with two weight buffers where they fit,
// for items of `fb` features, `nbuf` row buffers and at most `max_threads`
// threads; returns the shared bytes, 0 if nothing fits.
size_t wide_layout(const Net* nets, int count, int s, int extra_rows,
                   int extra_cols, wide::Layout* lay, int fb = wide::FB,
                   const int* tiles = WIDE_TILES, int nbuf = 3,
                   int max_threads = wide::MAX_THREADS) {
  for (; *tiles != 0; ++tiles)
    for (int two = 1; two >= 0; --two) {
      const size_t bytes =
          wide_plan(nets, count, s, *tiles, two == 1, extra_rows, extra_cols,
                    lay, fb, nbuf, max_threads) * sizeof(float);
      if (bytes <= static_cast<size_t>(MAX_SMEM)) return bytes;
    }
  return 0;
}

}  // namespace
