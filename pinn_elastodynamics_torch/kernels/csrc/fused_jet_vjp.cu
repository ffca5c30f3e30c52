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
//                             the full seed cotangent, full_dx).  Two
//                             bodies of that name, chosen by the launcher
//                             from the net's widths: the wide-tile body, and
//                             the wide140 body (its 4th template argument
//                             the reduction groups) where the wide-tile
//                             layout fits only one weight buffer.
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
// against a few hundred bytes of seed, cotangent and result per point.  The
// wide-tile body also recomputes the non-value pre-activations of every
// hidden layer in the reverse sweep (2 (S - 1) sum over hidden layers),
// which saves workspace and is not work the function needs; the wide140
// body saves them instead.
//
// Grid.  The Pallas kernels zero dW/db at grid step 0 and accumulate into
// an output block that every step revisits, which is safe only because a
// TPU grid runs in order.  Here a fixed number of blocks (at most one per
// SM) each walk their tiles of T points in a fixed order (tile b, b + G,
// b + 2G, ...) and keep ONE partial gradient per block in global memory (the
// packed parameter layout; a block's partial stays in L2).  A thread owns the
// same gradient elements in every tile, so the read-modify-write needs no
// synchronisation.  A second kernel sums the G partials in block order.  No
// float atomics: two runs give bitwise-equal gradients.
//
// Tile.  Both kernels run one net's sweep with the same device functions
// (the wide-tile design, described before namespace wide below; the
// wide140 body has its own, described before namespace wide140): 32-point
// tiles (16 or 8 for wider nets), the remat's saved activations in a
// per-block workspace in global memory (L2), three row buffers and two
// weight buffers in shared memory filled by cp.async while the previous
// layer runs, register-blocked products.  mlp_jet_bwd_kernel runs one net's
// remat and reverse sweep per tile; composite_jet_bwd_kernel runs the three
// nets in turn (the order is described before it), so its workspace is the
// uv net's and its shared memory that of the widest net plus the combine's
// five-row buffers.
//
// The launchers take device pointers, sizes and a cudaStream_t, launch the
// main kernel and the reduction on that stream without synchronising, and
// return cudaGetLastError().  They are instantiated for 3 or 4 input
// coordinates, order 1 or 2; anything else, or a net too wide for shared
// memory at the smallest tile, returns cudaErrorInvalidValue.

#include "jet_wide.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

// Offsets of layer l's W and b in the packed buffer.
__device__ __forceinline__ void packed_offsets(const Net& net, int l,
                                               int* w_off, int* b_off) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += (net.dims[i] + 1) * net.dims[i + 1];
  *w_off = off;
  *b_off = off + net.dims[l] * net.dims[l + 1];
}

// ---------------------------------------------------------------------------
// The wide-tile design.  Its forward pieces (the layout, weight staging,
// remat_net and head_forward) are in jet_wide.cuh, shared with the forward
// kernels of fused_jet.cu; the reverse sweep is here.
//
// A tile is 32 points (16 or 8 where 32 does not fit), and shared memory
// holds only the layers in flight.  A buffer of width W is W rows of RS =
// S * T + 4 floats, element [k * RS + s * T + p] being feature k of stream s
// at point p (the 4-float pad spreads neighbouring rows over the banks).
// The remat writes every hidden layer's output act[m] (m = 1 .. L-1, all S
// streams) to a per-block workspace in global memory, which stays in L2;
// the seed act[0] is not saved, since it is rebuilt from the kernel's
// input.  Three row buffers take the activations and cotangents in turn:
// act[m] lives in buffer slot(m), and when the reverse sweep is done with
// it, the same buffer receives act[m]'s cotangent.  The head's output
// cotangent is the cotangent of "act[L]".  So at reverse layer l the input
// act[l] is in slot(l), the output cotangent in slot(l + 1), and slot(l - 1)
// is free: while layer l runs, act[l - 1] is copied into it from the
// workspace (or the seed is rebuilt there) with cp.async, and layer l - 1's
// weights into the second of two weight buffers (a net too wide for two,
// such as a 140-wide one, gets one, and each layer's weights are copied
// when the layer starts).  The remat overlaps the next layer's weights the
// same way.  The launcher takes the largest tile that fits, with two weight
// buffers where they fit.  The input cotangent overwrites act[l] in place
// once the weight gradient has read it; layer 0 hands the seed cotangent to
// the kernel (a sink: dseed in global memory, or the composite's dx sum).
// The value row h of a layer's output, which the reverse epilogue needs, is
// read from the workspace.
//
// Products are register blocked: an item computes FB output features for P
// points of every stream (FB * P * S accumulators), so each float4 of
// activations it loads from shared memory (shared by the lanes of a warp,
// which differ in the feature) feeds FB * 4 FMAs; the weight gradient
// blocks KB rows by JB columns.  The block has as many threads as a hidden
// layer has items (288 at 70 features and 32 points), up to 512.
namespace wide {

constexpr int KB = 5;    // weight-gradient rows per item
constexpr int JB = 4;    // weight-gradient columns per item

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

// Reverse of a hidden layer's tanh-jet epilogue, in place on c (width fo);
// z of the non-value streams is recomputed from s_in, h read from h_g
// (the layer's saved output in the workspace).  F features per item.
template <int S, bool DTT, int T, int F>
__device__ void reverse_epilogue(float* c, const float* s_in,
                                 const float* h_g, int fi, int fo,
                                 const float* ws, int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  const int groups = (fo + F - 1) / F;
  const int items = groups * (T / P);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q0 = (it / groups) * P;
    int jc[F];
    float4 h4[F];
#pragma unroll
    for (int m = 0; m < F; ++m) {
      jc[m] = min(it % groups + m * groups, fo - 1);
      h4[m] = load_cg(reinterpret_cast<const float4*>(h_g + jc[m] * rs + q0));
    }
    float z[F][S][P];  // z[.][0] unused: the value stream needs no recompute
#pragma unroll
    for (int m = 0; m < F; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q) z[m][s][q] = 0.0f;
    const float* row = s_in + q0;
#pragma unroll 2
    for (int k = 0; k < fi; ++k, row += rs) {
      float w[F];
#pragma unroll
      for (int m = 0; m < F; ++m) w[m] = ws[k * fo + jc[m]];
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(row + s * T);
#pragma unroll
        for (int m = 0; m < F; ++m) {
          z[m][s][0] = fmaf(a.x, w[m], z[m][s][0]);
          z[m][s][1] = fmaf(a.y, w[m], z[m][s][1]);
          z[m][s][2] = fmaf(a.z, w[m], z[m][s][2]);
          z[m][s][3] = fmaf(a.w, w[m], z[m][s][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < F; ++m) {
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
// and read neighbouring rows of c.  The bias columns go to the block's
// last threads, which have the fewest items.
template <int S, int T, int KB, int JB>
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
  for (int j = blockDim.x - 1 - threadIdx.x; j < fo; j += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < T; ++p) acc += c[j * rs + p];
    gb[j] = first ? acc : gb[j] + acc;
  }
}

// c_in = c W^T, the cotangent of the layer's input (width fi), into the
// rows `out`; or, with out null, each input feature k's S x P block of
// points q0 .. q0 + P - 1 handed to sink(k, q0, block).  F input features
// per item.
template <int S, int T, int F, class Sink>
__device__ void backward_product(const float* c, int fo, const float* ws,
                                 int fi, float* out, int rs, Sink sink) {
  const int groups = (fi + F - 1) / F;
  const int items = groups * (T / P);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q0 = (it / groups) * P;
    const float* wr[F];
#pragma unroll
    for (int m = 0; m < F; ++m)
      wr[m] = ws + min(it % groups + m * groups, fi - 1) * fo;
    float acc[F][S][P];
#pragma unroll
    for (int m = 0; m < F; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[m][s][q] = 0.0f;
    const float* row = c + q0;
#pragma unroll 2
    for (int j = 0; j < fo; ++j, row += rs) {
      float w[F];
#pragma unroll
      for (int m = 0; m < F; ++m) w[m] = wr[m][j];
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
      sink(k, q0, acc[m]);
    }
  }
}

template <int S, int T, class Sink>
__device__ void backward_any(const float* c, int fo, const float* ws, int fi,
                             float* out, int rs, int threads, Sink sink) {
  if (narrow(fi, T, threads))
    backward_product<S, T, 1>(c, fo, ws, fi, out, rs, sink);
  else
    backward_product<S, T, FB>(c, fo, ws, fi, out, rs, sink);
}

// The weight gradient in KB x JB blocks, or in 2 x 2 or single elements
// where the larger blocks would leave most of the block idle.
template <int S, int T>
__device__ void weight_grads(const float* s_in, int fi, const float* c,
                             int fo, float* gw, float* gb, bool first, int rs,
                             int threads) {
  auto items = [&](int kb, int jb) {
    return 4 * ((fi + kb - 1) / kb) * ((fo + jb - 1) / jb);
  };
  const int n = threads;
  if (items(KB, JB) > n)
    accumulate_grads<S, T, KB, JB>(s_in, fi, c, fo, gw, gb, first, rs);
  else if (items(2, 2) > n)
    accumulate_grads<S, T, 2, 2>(s_in, fi, c, fo, gw, gb, first, rs);
  else
    accumulate_grads<S, T, 1, 1>(s_in, fi, c, fo, gw, gb, first, rs);
}

// Reverse sweep of net `id` on one tile after remat_net: from the head
// cotangent in `c_head` (width dims[L], row stride rs; read only) down to
// layer 0, whose seed cotangent goes to `sink` (see backward_product).
// Accumulates into the block's partial gradient `g` of this net; `save` is
// the workspace remat_net wrote, fill_seed the same as there and s0 what
// remat_net returned.
template <int S, bool DTT, int T, class Seed, class Sink>
__device__ void reverse_net(const Net& net, int id, const Layout& lay,
                            float* smem, int* held, const float* save,
                            const float* s0, const float* c_head, float* g,
                            bool first, Seed fill_seed, Sink sink) {
  const int L = net.n_layers;
  const int rs = lay.rs;
  auto rows = [&](int m) { return smem + lay.buf[slot(m, L)]; };
  const float* wact[MAX_LAYERS];  // act[m], m >= 1, in the workspace
  for (int m = 1; m < L; ++m) {
    wact[m] = save;
    save += static_cast<size_t>(net.dims[m]) * rs;
  }
  for (int l = L - 1; l >= 0; --l) {
    const int fi = net.dims[l];
    const int fo = net.dims[l + 1];
    const float* ws = begin_layer(net, id, l, l - 1, lay, smem, held);
    if (l >= 1 && l + 1 < L) {  // act[L - 2] is still resident
      if (l == 1)
        s0 = fill_seed(rows(0));
      else
        copy_rows(rows(l - 1), wact[l - 1], net.dims[l - 1] * rs);
    }
    copy_async_commit();
    const float* s_in = l == 0 ? s0 : rows(l);
    const float* c = l + 1 == L ? c_head : rows(l + 1);
    if (l + 1 < L) {
      if (narrow(fo, T, lay.threads))
        reverse_epilogue<S, DTT, T, 1>(rows(l + 1), s_in, wact[l + 1], fi, fo,
                                       ws, rs);
      else
        reverse_epilogue<S, DTT, T, FB>(rows(l + 1), s_in, wact[l + 1], fi,
                                        fo, ws, rs);
      __syncthreads();
    }
    int w_off, b_off;
    packed_offsets(net, l, &w_off, &b_off);
    weight_grads<S, T>(s_in, fi, c, fo, g + w_off, g + b_off, first, rs,
                       lay.threads);
    if (l > 0) {
      __syncthreads();  // the weight gradient is done with act[l]
      backward_any<S, T>(c, fo, ws, fi, rows(l), rs, lay.threads, sink);
    } else {
      backward_any<S, T>(c, fo, ws, fi, nullptr, rs, lay.threads, sink);
    }
  }
}

}  // namespace wide

// ---------------------------------------------------------------------------
// The body for nets too wide for two weight buffers (namespace wide140): the
// 140-wide nets at a 16-point tile, and 100 x 8 at 32 points.  What bounds
// it: the card's FFMA rate (the products are 99% of its operations at
// 3 -> 6 x 140 -> 7) and, at these small tiles, the rate at which shared
// memory feeds them.  Timed per phase on an H100 (clock64, one block), the
// wide-tile body spent 47% of a tile in the weight gradient, whose
// read-modify-write of the block's partial waited on one round trip to L2 or
// device memory per element, in turn; 37% in products whose items fed 32
// FMAs from 18 floats of shared memory (the input cotangent's weight reads
// also four-way bank conflicted); 7% copying each layer's weights into the
// lone buffer while nothing ran.  This body:
//   - loads the weight gradient's partial elements before its product, so
//     their latency overlaps it, in blocks laid out 4 by 8 over a warp's
//     lanes, so each operand load reads 4 or 8 float4s;
//   - writes each product as rows (gemm_rows): an item takes 4 outputs by 8
//     stream-points, so 4 weight and 8 activation floats feed 32 FMAs, and a
//     warp's weight loads read 4 conflict-free words; two reduction groups
//     sum the two halves of the reduction in their own rows, each in order,
//     added in a pass of their own (the tanh epilogue, or the input
//     cotangent's sink), so a 140-wide layer has 560 items; where the second
//     group's rows do not fit (five streams, 32 points), one group;
//   - has the remat save each hidden layer's value row and raw tangent
//     pre-activations z (not g z), so the reverse epilogue reads z instead of
//     recomputing it with a product; a reloaded layer input is turned back
//     into g z in shared memory;
//   - copies each layer's weights while the previous epilogue runs in the
//     remat, and while the epilogue and weight gradient run in the reverse
//     sweep, which needs them only for the input cotangent.
// Exact f32 FFMA and tanhf as everywhere here; the sums of the products are
// taken in two halves, so the gradients are not the wide-tile body's
// bitwise, and two runs give the same bits.
namespace wide140 {

using wide::P;

constexpr int OT = 4;               // output features per product item
constexpr int THREADS_BOUND = 640;  // launch bound: 96 registers a thread

struct Plan {
  int T;           // points per tile
  int rs;          // row stride, S * T + 4
  int buf[3];      // offsets of the three row buffers
  int wbuf;        // offset of the staged weights
  int bias[2];     // offsets of the staged biases of even and odd layers
  int scratch;     // offset of the second reduction group's rows
  int ks;          // reduction groups of a product: 2 where scratch fits
  int threads;
  long ws_floats;  // workspace per block
};

// Layer l's W (row-major, as packed) at w and, with b non-null, its bias
// at b: 16-byte copies where the source allows them.
__device__ void stage_weights(const Net& net, int l, float* w, float* b) {
  const int n_w = net.dims[l] * net.dims[l + 1];
  const float* src = net.w[l];
  if (n_w % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
    for (int i = 4 * threadIdx.x; i < n_w; i += 4 * blockDim.x)
      copy_async16(w + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n_w; i += blockDim.x)
      copy_async4(w + i, src + i);
  }
  if (b != nullptr)
    for (int i = threadIdx.x; i < net.dims[l + 1]; i += blockDim.x)
      copy_async4(b + i, net.b[l] + i);
}

// The product of a layer on one tile, written as rows: out[o][r] = sum
// over k of w(k, o) x[k][r], r over the S * T stream-points of a row; w(k,
// o) = ws[k * ld + o] (the forward: x is the layer input, o a feature), or
// with TRANSPOSED ws[o * ld + k] (the input cotangent: x is the output
// cotangent, o an input feature).  An item takes OT values of o, strided by
// the number of o groups, by 8 columns r (the float4 chunks rt and rt + S *
// T / 8 of a row), so each float loaded from shared memory feeds OT or 8
// FMAs; the lanes of a warp take 8 chunks (a 128-byte row segment) by 4
// consecutive o groups, so a warp's weight load reads 4 words.  The KS
// reduction groups each sum their own rows of k in order, group 0 into the
// rows at dst0 and group 1 into those at dst1; the caller adds them.
template <int KS, bool TRANSPOSED>
__device__ void gemm_rows(const float* x, int kn, int on, const float* ws,
                          int ld, int rn, float* dst0, float* dst1, int rs) {
  const int rtn = rn / 8;
  const int groups = (on + OT - 1) / OT;
  const int tiles = rtn * groups;
  const int kc = (kn + KS - 1) / KS;
  for (int e = threadIdx.x; e < tiles * KS; e += blockDim.x) {
    const int part = e / tiles;
    const int rt = e % rtn;
    const int og = (e % tiles) / rtn;
    const int k1 = min(kn, (part + 1) * kc);
    const float* wo[OT];
#pragma unroll
    for (int m = 0; m < OT; ++m) {
      const int o = min(og + m * groups, on - 1);  // clamped; not stored
      wo[m] = TRANSPOSED ? ws + o * ld : ws + o;
    }
    float acc[OT][8];
#pragma unroll
    for (int m = 0; m < OT; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[m][i] = 0.0f;
#pragma unroll 4
    for (int k = part * kc; k < k1; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(x + k * rs + 4 * rt);
      const float4 v =
          *reinterpret_cast<const float4*>(x + k * rs + 4 * (rt + rtn));
#pragma unroll
      for (int m = 0; m < OT; ++m) {
        const float w = TRANSPOSED ? wo[m][k] : wo[m][k * ld];
        acc[m][0] = fmaf(u.x, w, acc[m][0]);
        acc[m][1] = fmaf(u.y, w, acc[m][1]);
        acc[m][2] = fmaf(u.z, w, acc[m][2]);
        acc[m][3] = fmaf(u.w, w, acc[m][3]);
        acc[m][4] = fmaf(v.x, w, acc[m][4]);
        acc[m][5] = fmaf(v.y, w, acc[m][5]);
        acc[m][6] = fmaf(v.z, w, acc[m][6]);
        acc[m][7] = fmaf(v.w, w, acc[m][7]);
      }
    }
    float* dst = part == 0 ? dst0 : dst1;
#pragma unroll
    for (int m = 0; m < OT; ++m) {
      const int o = og + m * groups;
      if (o >= on) continue;
      float* d = dst + o * rs;
      *reinterpret_cast<float4*>(d + 4 * rt) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(d + 4 * (rt + rtn)) =
          make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
}

// The fo rows of z at `out` (plus, with `part` non-null, the second
// reduction group's rows there, added in that order) through a hidden
// layer's tanh-jet epilogue, in place; the workspace rows at out_g receive
// the value row h and the raw tangent pre-activations z (the reverse
// epilogue's operands).
template <int S, bool DTT, int T>
__device__ void forward_epilogue(float* out, const float* part,
                                 const float* bs, int fo, float* out_g,
                                 int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  for (int it = threadIdx.x; it < fo * (T / P); it += blockDim.x) {
    const int j = it / (T / P);
    const int off = j * rs + (it % (T / P)) * P;
    float z[S][P];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float4 v = *reinterpret_cast<const float4*>(out + off + s * T);
      if (part != nullptr) {
        const float4 u = *reinterpret_cast<const float4*>(part + off + s * T);
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
      if (s > 0) *reinterpret_cast<float4*>(out_g + off + s * T) = v;
      z[s][0] = v.x;
      z[s][1] = v.y;
      z[s][2] = v.z;
      z[s][3] = v.w;
    }
    const float bj = bs[j];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float h = tanhf(z[0][q] + bj);
      const float g = 1.0f - h * h;
      if (DTT) {
        const float zt = z[NT][q];
        z[S - 1][q] = g * z[S - 1][q] - 2.0f * h * g * (zt * zt);
      }
#pragma unroll
      for (int s = 1; s <= NT; ++s) z[s][q] *= g;
      z[0][q] = h;
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(out + off + s * T) =
          make_float4(z[s][0], z[s][1], z[s][2], z[s][3]);
    *reinterpret_cast<float4*>(out_g + off) =
        make_float4(z[0][0], z[0][1], z[0][2], z[0][3]);
  }
}

// Remat of the net's hidden layers on one tile, as wide::remat_net with a
// save, each layer's product by gemm_rows, then its epilogue.  A layer's
// weights are copied while the previous layer's epilogue runs (its bias
// into the other of two slots), and the last epilogue overlaps the copy of
// the head's, which the reverse sweep takes first.  The net has a hidden
// layer (see mlp_bwd_body).  Returns act[0].
template <int S, bool DTT, int T, int KS, class Seed, class Cot>
__device__ const float* remat_net(const Net& net, const Plan& pl,
                                  float* smem, float* save, Seed fill_seed,
                                  Cot place_cot) {
  const int L = net.n_layers;
  auto rows = [&](int m) { return smem + pl.buf[wide::slot(m, L)]; };
  auto bias = [&](int l) { return smem + pl.bias[l & 1]; };
  float* ws = smem + pl.wbuf;
  float* part = KS == 2 ? smem + pl.scratch : nullptr;
  const float* s0 = fill_seed(rows(0));
  stage_weights(net, 0, ws, bias(0));
  copy_async_commit();
  for (int l = 0; l + 1 < L; ++l) {
    copy_async_wait();
    __syncthreads();
    if (l + 2 == L) {
      place_cot(rows(L));
      copy_async_commit();
    }
    const int fo = net.dims[l + 1];
    gemm_rows<KS, false>(l == 0 ? s0 : rows(l), net.dims[l], fo, ws, fo,
                         S * T, rows(l + 1), part, pl.rs);
    __syncthreads();  // the product is done with W_l
    stage_weights(net, l + 1, ws, l + 2 < L ? bias(l + 1) : nullptr);
    copy_async_commit();
    forward_epilogue<S, DTT, T>(rows(l + 1), part, bias(l), fo, save, pl.rs);
    save += static_cast<size_t>(fo) * pl.rs;
  }
  return s0;
}

// act[l] reloaded from the workspace (h, raw z) back into the jet the
// forward produced: g z for the tangents and, with DTT, g z_tt - 2 h g
// z_t^2, in place on the fi rows at x.
template <int S, bool DTT, int T>
__device__ void activate_rows(float* x, int fi, int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  for (int i = threadIdx.x; i < fi * T; i += blockDim.x) {
    float* r = x + (i / T) * rs + i % T;
    const float h = r[0];
    const float g = 1.0f - h * h;
    if (DTT) {
      const float zt = r[NT * T];
      r[(S - 1) * T] = g * r[(S - 1) * T] - 2.0f * h * g * (zt * zt);
    }
#pragma unroll
    for (int s = 1; s <= NT; ++s) r[s * T] *= g;
  }
}

// Reverse of a hidden layer's tanh-jet epilogue, in place on the fo rows
// of c, as wide::reverse_epilogue with h and z read from the layer's saved
// output h_g instead of recomputed.
template <int S, bool DTT, int T>
__device__ void reverse_epilogue(float* c, const float* h_g, int fo,
                                 int rs) {
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  for (int it = threadIdx.x; it < fo * (T / P); it += blockDim.x) {
    const int off = (it / (T / P)) * rs + (it % (T / P)) * P;
    float cv[S][P];
    float z[S][P];  // z[0] is h
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(c + off + s * T);
      const float4 u =
          load_cg(reinterpret_cast<const float4*>(h_g + off + s * T));
      cv[s][0] = v.x;
      cv[s][1] = v.y;
      cv[s][2] = v.z;
      cv[s][3] = v.w;
      z[s][0] = u.x;
      z[s][1] = u.y;
      z[s][2] = u.z;
      z[s][3] = u.w;
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float h = z[0][q];
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
        chh += ctt * (-2.0f * h * ztt -
                      2.0f * (1.0f - 3.0f * h * h) * (zt * zt));
        ct[NT] += ctt * (-4.0f * h * g * zt);
        ct[S - 1] = g * ctt;
      }
      ct[0] = g * chh;
#pragma unroll
      for (int s = 0; s < S; ++s) cv[s][q] = ct[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(c + off + s * T) =
          make_float4(cv[s][0], cv[s][1], cv[s][2], cv[s][3]);
  }
}

// The tile's dW = s_in^T c and db, as wide::accumulate_grads (each
// element the same sum in the same order), in KB x JB blocks laid out so
// that a warp's lanes take 4 row blocks by 8 column blocks (each activation
// or cotangent load reads 4 or 8 float4s); an item loads its partial's
// elements before its product, whose time then hides their latency.
template <int S, int T, int KB, int JB>
__device__ void accumulate_grads(const float* s_in, int fi, const float* c,
                                 int fo, float* gw, float* gb, bool first,
                                 int rs) {
  const int kgroups = (fi + KB - 1) / KB;
  const int jgroups = (fo + JB - 1) / JB;
  const int jwarps = (jgroups + 7) / 8;
  const int items = round_up(kgroups, 4) * jwarps * 8;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int lane = e % 32;
    const int kg = (e / 32 / jwarps) * 4 + lane / 8;
    const int jg = (e / 32 % jwarps) * 8 + lane % 8;
    if (kg >= kgroups || jg >= jgroups) continue;
    const int k0 = kg * KB;
    float prior[KB][JB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int k = k0 + kk;
        const int j = jg + jj * jgroups;
        prior[kk][jj] = (!first && k < fi && j < fo) ? gw[k * fo + j] : 0.0f;
      }
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
        if (k < fi && j < fo)
          gw[k * fo + j] = first ? acc[kk][jj] : prior[kk][jj] + acc[kk][jj];
      }
  }
  for (int j = blockDim.x - 1 - threadIdx.x; j < fo; j += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < T; ++p) acc += c[j * rs + p];
    gb[j] = first ? acc : gb[j] + acc;
  }
}

// The weight gradient in KB x JB blocks, or 2 x 2 or single elements, by
// the rule of wide::weight_grads.
template <int S, int T>
__device__ void weight_grads(const float* s_in, int fi, const float* c,
                             int fo, float* gw, float* gb, bool first, int rs,
                             int threads) {
  using wide::JB;
  using wide::KB;
  auto items = [&](int kb, int jb) {
    return 4 * ((fi + kb - 1) / kb) * ((fo + jb - 1) / jb);
  };
  if (items(KB, JB) > threads)
    accumulate_grads<S, T, KB, JB>(s_in, fi, c, fo, gw, gb, first, rs);
  else if (items(2, 2) > threads)
    accumulate_grads<S, T, 2, 2>(s_in, fi, c, fo, gw, gb, first, rs);
  else
    accumulate_grads<S, T, 1, 1>(s_in, fi, c, fo, gw, gb, first, rs);
}

// The input cotangent's rows at `rows` (fi of them), plus the second
// reduction group's at `part` if non-null: summed in that order into
// `rows`, or with `to_sink` each input feature k's S x P block of points q0
// .. q0 + P - 1 handed to sink(k, q0, block).
template <int S, int T, class Sink>
__device__ void input_cotangent(float* rows, const float* part, int fi,
                                int rs, bool to_sink, Sink sink) {
  for (int it = threadIdx.x; it < fi * (T / P); it += blockDim.x) {
    const int k = it / (T / P);
    const int q0 = (it % (T / P)) * P;
    float v[S][P];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int off = k * rs + s * T + q0;
      float4 a = *reinterpret_cast<const float4*>(rows + off);
      if (part != nullptr) {
        const float4 b = *reinterpret_cast<const float4*>(part + off);
        a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        if (!to_sink) *reinterpret_cast<float4*>(rows + off) = a;
      }
      v[s][0] = a.x;
      v[s][1] = a.y;
      v[s][2] = a.z;
      v[s][3] = a.w;
    }
    if (to_sink) sink(k, q0, v);
  }
}

// Reverse sweep on one tile after remat_net, as wide::reverse_net.  Per
// layer l, in copy groups that let each copy overlap the phases before its
// use: wait for act[l] (copied during layer l + 1) and start copying act[l
// - 1]; activate a reloaded act[l] and run the epilogue on c; the weight
// gradient; wait for W_l (copied during layer l + 1's tail) and compute the
// input cotangent; start copying W_{l-1}.
template <int S, bool DTT, int T, int KS, class Seed, class Sink>
__device__ void reverse_net(const Net& net, const Plan& pl, float* smem,
                            const float* save, const float* s0,
                            const float* c_head, float* g, bool first,
                            Seed fill_seed, Sink sink) {
  const int L = net.n_layers;
  const int rs = pl.rs;
  auto rows = [&](int m) { return smem + pl.buf[wide::slot(m, L)]; };
  float* ws = smem + pl.wbuf;
  float* part = KS == 2 ? smem + pl.scratch : nullptr;
  const float* wact[MAX_LAYERS];  // act[m], m >= 1, in the workspace
  for (int m = 1; m < L; ++m) {
    wact[m] = save;
    save += static_cast<size_t>(net.dims[m]) * rs;
  }
  for (int l = L - 1; l >= 0; --l) {
    const int fi = net.dims[l];
    const int fo = net.dims[l + 1];
    copy_async_wait_prior();
    __syncthreads();
    if (l >= 1 && l + 1 < L) {  // act[L - 2] is still resident
      if (l == 1)
        s0 = fill_seed(rows(0));
      else
        wide::copy_rows(rows(l - 1), wact[l - 1], net.dims[l - 1] * rs);
    }
    copy_async_commit();
    const float* s_in = l == 0 ? s0 : rows(l);
    const float* c = l + 1 == L ? c_head : rows(l + 1);
    if (l + 1 < L) {
      if (l >= 1 && l + 3 <= L) activate_rows<S, DTT, T>(rows(l), fi, rs);
      reverse_epilogue<S, DTT, T>(rows(l + 1), wact[l + 1], fo, rs);
      __syncthreads();
    }
    int w_off, b_off;
    packed_offsets(net, l, &w_off, &b_off);
    weight_grads<S, T>(s_in, fi, c, fo, g + w_off, g + b_off, first, rs,
                       pl.threads);
    copy_async_wait_prior();
    __syncthreads();  // the weight gradient is done with act[l]; W_l landed
    gemm_rows<KS, true>(c, fo, fi, ws, fo, S * T, rows(l), part, rs);
    __syncthreads();  // the product is done with W_l
    if (l > 0) {
      stage_weights(net, l - 1, ws, nullptr);
      copy_async_commit();
    }
    if (part != nullptr || l == 0)
      input_cotangent<S, T>(rows(l), part, fi, rs, l == 0, sink);
  }
}

}  // namespace wide140

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
  float* save = workspace + static_cast<size_t>(blockIdx.x) * lay.ws_floats;
  int held[2] = {-1, -1};

  const int tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int n0 = tile * T;
    const int nvalid = min(T, n - n0);
    auto seed = [&](float* dst) -> const float* {
      gather_seed<S, DTT, T>(seed_f, seed_d, seed_tt, n, n0, nvalid, e, rs,
                             dst);
      return dst;
    };
    auto head_cot = [&](float* dst) {
      gather_cot<S, T>(cot, n, n0, nvalid, net.dims[L], rs, dst);
    };
    auto to_dseed = [&](int k, int q0, const float (&v)[S][P]) {
      for (int s = 0; s < (full_dx ? S : 1); ++s)
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (q0 + q < nvalid)
            dseed[(static_cast<size_t>(s) * n + n0 + q0 + q) * e + k] =
                v[s][q];
    };
    __syncthreads();  // the previous tile is done with shared memory
    const float* s0 =
        remat_net<S, DTT, T>(net, 0, lay, smem, held, save, seed, head_cot);
    reverse_net<S, DTT, T>(net, 0, lay, smem, held, save, s0,
                           smem + lay.buf[slot(L, L)], g, first, seed,
                           to_dseed);
  }
}

// The same sweep on the wide140 body (the launcher takes it for nets too
// wide for two weight buffers; see namespace wide140).
template <int S, bool DTT, int T, int KS>
__global__ void __launch_bounds__(wide140::THREADS_BOUND, 1)
mlp_jet_bwd_kernel(const float* __restrict__ seed_f,
                   const float* __restrict__ seed_d,
                   const float* __restrict__ seed_tt,
                   const float* __restrict__ cot, int n, Net net,
                   wide140::Plan pl, float* __restrict__ partial,
                   int n_params, int full_dx, float* __restrict__ dseed,
                   float* workspace) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = net.n_layers;
  const int e = net.dims[0];
  float* g = partial + static_cast<size_t>(blockIdx.x) * n_params;
  float* save = workspace + static_cast<size_t>(blockIdx.x) * pl.ws_floats;

  const int tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int n0 = tile * T;
    const int nvalid = min(T, n - n0);
    auto seed = [&](float* dst) -> const float* {
      wide::gather_seed<S, DTT, T>(seed_f, seed_d, seed_tt, n, n0, nvalid, e,
                                   pl.rs, dst);
      return dst;
    };
    auto head_cot = [&](float* dst) {
      wide::gather_cot<S, T>(cot, n, n0, nvalid, net.dims[L], pl.rs, dst);
    };
    auto to_dseed = [&](int k, int q0, const float (&v)[S][wide::P]) {
      for (int s = 0; s < (full_dx ? S : 1); ++s)
#pragma unroll
        for (int q = 0; q < wide::P; ++q)
          if (q0 + q < nvalid)
            dseed[(static_cast<size_t>(s) * n + n0 + q0 + q) * e + k] =
                v[s][q];
    };
    __syncthreads();  // the previous tile is done with shared memory
    const float* s0 =
        wide140::remat_net<S, DTT, T, KS>(net, pl, smem, save, seed,
                                          head_cot);
    wide140::reverse_net<S, DTT, T, KS>(net, pl, smem, save, s0,
                                        smem + pl.buf[wide::slot(L, L)], g,
                                        first, seed, to_dseed);
  }
}

// The composite's sweep of one tile, in this order:
//   1. the output cotangent c into its own buffer;
//   2. remat of dist up to its head output fd, saving nothing;
//   3. remat of uv, saving its rows in the workspace, and its head fu;
//   4. reverse of y = part + dist * uv into cu (the uv head's cotangent,
//      in uv's free row buffer) and cd;
//   5. reverse sweep of uv, whose top activations are still resident;
//   6. remat of dist again, now saving its rows in the workspace uv is done
//      with, and its reverse sweep from cd;
//   7. remat and reverse sweep of part from c;
//   8. the three value-row seed cotangents, summed in shared memory in the
//      order uv, dist, part, into dx.
// The second remat of dist costs about 4% of the uv net's work at the plate
// widths; saving all three nets' rows instead would need 720 rows of
// workspace per block where uv alone needs 560, more than the L2 holds at
// one block per SM.  The seed is built once per tile from x (raw or
// normalised) into a buffer of its own, which every net reads as act[0].
template <int S, bool DTT, int T>
__global__ void __launch_bounds__(wide::MAX_THREADS, 1)
composite_jet_bwd_kernel(const float* __restrict__ xg, int n, int a,
                         Norm norm, Net nu, Net nd, Net np,
                         const float* __restrict__ cot, wide::Layout lay,
                         float* __restrict__ partial, int n_params,
                         float* __restrict__ dx, float* workspace) {
  using namespace wide;
  constexpr int NT = S - 1 - (DTT ? 1 : 0);
  enum { UV, DIST, PART };
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rs = lay.rs;
  const int c_out = nu.dims[nu.n_layers];
  float* c = smem + lay.extra;   // output cotangent
  float* cd = c + c_out * rs;    // dist head's cotangent
  float* fd = cd + c_out * rs;   // dist output jet
  float* fu = fd + c_out * rs;   // uv output jet
  float* s0 = fu + c_out * rs;   // seed streams, width a
  float* dxs = s0 + a * rs;      // (a, T) summed value-row seed cotangent
  float* cu = smem + lay.buf[slot(nu.n_layers, nu.n_layers)];
  float* gu = partial + static_cast<size_t>(blockIdx.x) * n_params;
  float* gd = gu + net_params(nu);
  float* gp = gd + net_params(nd);
  float* save = workspace + static_cast<size_t>(blockIdx.x) * lay.ws_floats;
  int held[2] = {-1, -1};
  bool add_dx = false;

  const int tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int n0 = tile * T;
    const int nvalid = min(T, n - n0);
    auto seed = [&](float*) -> const float* { return s0; };
    auto no_cot = [](float*) {};
    auto sum_dx = [&](int k, int q0, const float (&v)[S][P]) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* d = dxs + k * T + q0 + q;
        *d = add_dx ? *d + v[0][q] : v[0][q];
      }
    };
    __syncthreads();  // the previous tile is done with shared memory
    gather_cot<S, T>(cot, n, n0, nvalid, c_out, rs, c);
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
    remat_net<S, DTT, T>(nd, DIST, lay, smem, held, nullptr, seed, no_cot);
    head_forward<S, DTT, T>(nd, DIST, lay, smem, held, s0, fd);
    __syncthreads();
    remat_net<S, DTT, T>(nu, UV, lay, smem, held, save, seed, no_cot);
    head_forward<S, DTT, T>(nu, UV, lay, smem, held, s0, fu);
    __syncthreads();

    // Reverse of y = part + dist * uv (rows: value, tangents, dtt with
    // y_tt = p_tt + d_tt u + 2 d_t u_t + d u_tt).
    for (int i = threadIdx.x; i < c_out * T; i += blockDim.x) {
      const int r = (i / T) * rs + i % T;
      const float u0 = fu[r];
      const float d0 = fd[r];
      const float c0 = c[r];
      float acc_u = d0 * c0;
      float acc_d = u0 * c0;
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const int q = r + s * T;
        const float cs = c[q];
        acc_u += fd[q] * cs;
        acc_d += fu[q] * cs;
        cu[q] = d0 * cs;
        cd[q] = u0 * cs;
      }
      if (DTT) {
        const int t = r + NT * T;
        const float ctt = c[r + (S - 1) * T];
        cu[t] += 2.0f * fd[t] * ctt;
        cd[t] += 2.0f * fu[t] * ctt;
      }
      cu[r] = acc_u;
      cd[r] = acc_d;
    }

    add_dx = false;
    reverse_net<S, DTT, T>(nu, UV, lay, smem, held, save, s0, cu, gu, first,
                           seed, sum_dx);
    add_dx = true;
    __syncthreads();
    remat_net<S, DTT, T>(nd, DIST, lay, smem, held, save, seed, no_cot);
    reverse_net<S, DTT, T>(nd, DIST, lay, smem, held, save, s0, cd, gd, first,
                           seed, sum_dx);
    __syncthreads();
    remat_net<S, DTT, T>(np, PART, lay, smem, held, save, seed, no_cot);
    reverse_net<S, DTT, T>(np, PART, lay, smem, held, save, s0, c, gp, first,
                           seed, sum_dx);
    __syncthreads();
    for (int i = threadIdx.x; i < a * T; i += blockDim.x) {
      const int p = i % T;
      if (p < nvalid) dx[static_cast<size_t>(n0 + p) * a + i / T] = dxs[i];
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


// The composite's layout: the three nets, and the c, cd, fd and fu buffers
// (head width each), the seed (width a) and the (a, T) dx sum of
// composite_jet_bwd_kernel.
size_t composite_layout(const Net* nets, int s, int a, wide::Layout* lay) {
  return wide_layout(nets, 3, s, 4 * nets[0].dims[nets[0].n_layers] + a, a,
                     lay);
}

// The wide140 body's layout of a net at a tile of t points with ks
// reduction groups: three row buffers as wide_plan's, one weight buffer,
// two bias slots and, with ks = 2, the second group's rows; returns the
// shared floats it needs.
long wide140_plan(const Net& net, int s, int t, int ks, wide140::Plan* pl) {
  const int L = net.n_layers;
  pl->T = t;
  pl->rs = s * t + 4;
  pl->ks = ks;
  int rows[3] = {0, 0, 0};
  long wsize = 0;
  int bsize = 0;
  int widest = 0;  // the most rows a product writes
  long hidden = 0;
  for (int m = 0; m <= L; ++m) {
    int& r = rows[wide::slot(m, L)];
    r = std::max(r, net.dims[m]);
  }
  for (int l = 0; l < L; ++l) {
    const int n_w = round_up(net.dims[l] * net.dims[l + 1], 4);
    wsize = std::max(wsize, static_cast<long>(n_w));
    bsize = std::max(bsize, round_up(net.dims[l + 1], 4));
    widest = std::max(widest, net.dims[l]);
    if (l + 1 < L) widest = std::max(widest, net.dims[l + 1]);
  }
  for (int m = 1; m < L; ++m) hidden += net.dims[m];
  long off = 0;
  for (int b = 0; b < 3; ++b) {
    pl->buf[b] = static_cast<int>(off);
    off += static_cast<long>(rows[b]) * pl->rs;
  }
  pl->wbuf = static_cast<int>(off);
  off += wsize;
  for (int i = 0; i < 2; ++i) {
    pl->bias[i] = static_cast<int>(off);
    off += bsize;
  }
  pl->scratch = static_cast<int>(off);
  if (ks == 2) off += static_cast<long>(widest) * pl->rs;
  pl->ws_floats = hidden * pl->rs;
  const int items =
      (widest + wide140::OT - 1) / wide140::OT * (s * t / 8) * ks;
  pl->threads = std::min(wide140::THREADS_BOUND,
                         std::max(64, round_up(items, 32)));
  return off;
}

// The body of the MLP backward for a net: the wide140 body where the
// wide-tile layout fits only one weight buffer and the wide140 layout fits
// at the same tile (its plan in *pl, its shared bytes in *bytes); else the
// wide-tile body (*lay, *bytes).  BODY_NONE if neither fits.
enum Body { BODY_NONE = -1, BODY_TILE = 0, BODY_WIDE140 = 1 };

Body mlp_bwd_body(const Net& net, int s, wide::Layout* lay,
                  wide140::Plan* pl, size_t* bytes) {
  *bytes = wide_layout(&net, 1, s, 0, 0, lay);
  if (*bytes == 0) return BODY_NONE;
  // A one-layer net's second weight buffer is empty, so it always has two.
  if (lay->wbuf[0] != lay->wbuf[1]) return BODY_TILE;
  for (int ks = lay->T == 16 ? 2 : 1; ks >= 1; --ks) {
    const size_t b = wide140_plan(net, s, lay->T, ks, pl) * sizeof(float);
    if (b <= static_cast<size_t>(MAX_SMEM)) {
      *bytes = b;
      return BODY_WIDE140;
    }
  }
  return BODY_TILE;
}

template <int S, bool DTT>
int launch_mlp_bwd(const float* sf, const float* sd, const float* stt,
                   const float* cot, int n, const Net& net, int full_dx,
                   int max_blocks, float* partial, float* grad, float* dseed,
                   float* workspace, cudaStream_t stream) {
  wide::Layout lay;
  wide140::Plan pl;
  size_t bytes;
  const Body body = mlp_bwd_body(net, S, &lay, &pl, &bytes);
  if (body == BODY_NONE || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_params = static_cast<int>(net_params(net));
  int blocks;
  if (body == BODY_WIDE140) {
    const auto kern = pl.ks == 2   ? mlp_jet_bwd_kernel<S, DTT, 16, 2>
                      : pl.T == 32 ? mlp_jet_bwd_kernel<S, DTT, 32, 1>
                      : pl.T == 16 ? mlp_jet_bwd_kernel<S, DTT, 16, 1>
                                   : mlp_jet_bwd_kernel<S, DTT, 8, 1>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    blocks = grid_blocks(n, pl.T, max_blocks);
    kern<<<blocks, pl.threads, bytes, stream>>>(
        sf, sd, stt, cot, n, net, pl, partial, n_params, full_dx, dseed,
        workspace);
  } else {
    const auto kern = lay.T == 32   ? mlp_jet_bwd_kernel<S, DTT, 32>
                      : lay.T == 16 ? mlp_jet_bwd_kernel<S, DTT, 16>
                                    : mlp_jet_bwd_kernel<S, DTT, 8>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    blocks = grid_blocks(n, lay.T, max_blocks);
    kern<<<blocks, lay.threads, bytes, stream>>>(
        sf, sd, stt, cot, n, net, lay, partial, n_params, full_dx, dseed,
        workspace);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(partial, blocks, n_params, grad, stream);
}

template <int S, bool DTT>
int launch_composite_bwd(const float* x, int n, int a, const Norm& norm,
                         const Net* nets, const float* cot, int max_blocks,
                         float* partial, float* grad, float* dx,
                         float* workspace, cudaStream_t stream) {
  wide::Layout lay;
  const size_t bytes = composite_layout(nets, S, a, &lay);
  if (bytes == 0 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = lay.T == 32   ? composite_jet_bwd_kernel<S, DTT, 32>
                    : lay.T == 16 ? composite_jet_bwd_kernel<S, DTT, 16>
                                  : composite_jet_bwd_kernel<S, DTT, 8>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int blocks = grid_blocks(n, lay.T, max_blocks);
  const int n_params = static_cast<int>(
      net_params(nets[0]) + net_params(nets[1]) + net_params(nets[2]));
  kern<<<blocks, lay.threads, bytes, stream>>>(
      x, n, a, norm, nets[0], nets[1], nets[2], cot, lay, partial, n_params,
      dx, workspace);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(partial, blocks, n_params, grad, stream);
}

// A net of these widths without parameters, for the size queries; false if
// a width or the depth is out of range.
bool net_of_widths(const int* dims, int n_layers, Net* net) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  net->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return false;
    net->dims[l] = dims[l];
  }
  return true;
}

// The composite's nets all read the a input coordinates and share the head
// width.
bool composite_nets_fit(const Net* nets, int a) {
  if (a < 3 || a > 4) return false;
  const int c = nets[0].dims[nets[0].n_layers];
  for (int i = 0; i < 3; ++i)
    if (nets[i].dims[0] != a || nets[i].dims[nets[i].n_layers] != c)
      return false;
  return true;
}

int streams(int a, int order) { return 1 + a + (order == 2 ? 1 : 0); }

}  // namespace

extern "C" {

// Floats of workspace that fused_mlp_jet_bwd_launch needs per block for a
// net of these widths; -1 if the kernel does not take it.
long long fused_mlp_jet_bwd_workspace(int n_tangents, int order,
                                      const int* dims, int n_layers) {
  Net net;
  wide::Layout lay;
  wide140::Plan pl;
  size_t bytes;
  if (n_tangents < 3 || n_tangents > 4 || order < 1 || order > 2 ||
      !net_of_widths(dims, n_layers, &net))
    return -1;
  switch (mlp_bwd_body(net, streams(n_tangents, order), &lay, &pl, &bytes)) {
    case BODY_TILE: return lay.ws_floats;
    case BODY_WIDE140: return pl.ws_floats;
    default: return -1;
  }
}

// The body fused_mlp_jet_bwd_launch runs for a net of these widths: 0 the
// wide-tile body, 1 the wide140 body; -1 if the kernel does not take it.
int fused_mlp_jet_bwd_body(int n_tangents, int order, const int* dims,
                           int n_layers) {
  Net net;
  wide::Layout lay;
  wide140::Plan pl;
  size_t bytes;
  if (n_tangents < 3 || n_tangents > 4 || order < 1 || order > 2 ||
      !net_of_widths(dims, n_layers, &net))
    return -1;
  return mlp_bwd_body(net, streams(n_tangents, order), &lay, &pl, &bytes);
}

// Floats of workspace that fused_composite_jet_bwd_launch needs per block
// for nets of these widths (uv, dist, part); -1 if the kernel does not take
// them.
long long fused_composite_jet_bwd_workspace(int a, int order, const int* du,
                                            int lu, const int* dd, int ld,
                                            const int* dp, int lp) {
  Net nets[3];
  wide::Layout lay;
  if (order < 1 || order > 2 || !net_of_widths(du, lu, &nets[0]) ||
      !net_of_widths(dd, ld, &nets[1]) || !net_of_widths(dp, lp, &nets[2]) ||
      !composite_nets_fit(nets, a) ||
      composite_layout(nets, streams(a, order), a, &lay) == 0)
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
// value-row seed cotangent (before the normalisation's chain rule);
// workspace: max_blocks x fused_composite_jet_bwd_workspace(...) floats of
// scratch.
int fused_composite_jet_bwd_launch(const float* x, int n, int a, int order,
                                   const float* lb, const float* ub,
                                   const float* pu, const int* du, int lu,
                                   const float* pd, const int* dd, int ld,
                                   const float* pp, const int* dp, int lp,
                                   const float* cot, int max_blocks,
                                   float* partial, float* grad, float* dx,
                                   float* workspace, void* stream) {
  Net nets[3];
  if (!make_net(pu, du, lu, &nets[0]) || !make_net(pd, dd, ld, &nets[1]) ||
      !make_net(pp, dp, lp, &nets[2]) || !composite_nets_fit(nets, a) ||
      n < 0 || max_blocks < 1)
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
    case 6: return launch_composite_bwd<4, false>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, workspace, st);
    case 7: return launch_composite_bwd<5, true>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, workspace, st);
    case 8: return launch_composite_bwd<5, false>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, workspace, st);
    case 9: return launch_composite_bwd<6, true>(x, n, a, norm, nets, cot, max_blocks, partial, grad, dx, workspace, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
