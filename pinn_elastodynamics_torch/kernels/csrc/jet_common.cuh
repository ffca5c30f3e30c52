// Shared pieces of the fused-jet CUDA sources (fused_jet.cu, fused_jet_vjp.cu):
// the description of one tanh MLP as the kernels receive it, the input
// normalisation, and the host-side helpers that build and size them.
//
// A net arrives as one packed f32 buffer (per layer W row-major, then b) and
// its n_layers + 1 widths.  Gradients use the same packed layout, so a
// parameter's offset in the buffer is also its gradient's offset.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

struct Net {
  int n_layers;
  int dims[MAX_LAYERS + 1];
  const float* w[MAX_LAYERS];  // (dims[l], dims[l + 1]), row-major
  const float* b[MAX_LAYERS];  // (dims[l + 1],)
};

struct Norm {
  int on;
  float lb[4];
  float ub[4];
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Hopper primitives, each behind a small wrapper so that the sources also
// build for the CPU emulation (whose stub cuda_runtime.h gives plain
// versions: a copy for each asynchronous copy, no-ops for the waits).
#ifdef __CUDACC__
// Asynchronous copy of 4 bytes (cached in L1) or 16 bytes (L2 only) from
// global to shared memory; lands after copy_async_wait().
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for every copy this thread issued; a __syncthreads() after it makes
// all threads' copies visible to the block.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait for every committed group of this thread's copies but the newest.
__device__ __forceinline__ void copy_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Load that bypasses L1: reads what this block wrote to global memory
// earlier in the kernel.
__device__ __forceinline__ float4 load_cg(const float4* p) { return __ldcg(p); }
#endif

bool make_net(const float* packed, const int* dims, int n_layers, Net* net) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  net->n_layers = n_layers;
  size_t off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return false;
    net->dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net->w[l] = packed + off;
    off += static_cast<size_t>(dims[l]) * dims[l + 1];
    net->b[l] = packed + off;
    off += dims[l + 1];
  }
  return true;
}

// Number of floats in a packed net (and in its packed gradient).
__host__ __device__ inline size_t net_params(const Net& net) {
  size_t p = 0;
  for (int l = 0; l < net.n_layers; ++l)
    p += static_cast<size_t>(net.dims[l] + 1) * net.dims[l + 1];
  return p;
}

// lb/ub of the composite launchers: both null for raw coordinates.
Norm make_norm(const float* lb, const float* ub, int a) {
  Norm norm;
  norm.on = (lb != nullptr && ub != nullptr) ? 1 : 0;
  for (int k = 0; k < 4; ++k) {
    norm.lb[k] = (norm.on && k < a) ? lb[k] : 0.0f;
    norm.ub[k] = (norm.on && k < a) ? ub[k] : 1.0f;
  }
  return norm;
}

// Seed stream s of input coordinate k at one point of raw coordinates x:
// the (normalised) value, identity tangents scaled by the normalisation,
// zero second-time stream.  nt is the number of tangent streams.
__device__ __forceinline__ float seed_value(const Norm& norm, int s, int k,
                                            int nt, float x) {
  if (s == 0)
    return norm.on ? 2.0f * (x - norm.lb[k]) / (norm.ub[k] - norm.lb[k]) - 1.0f
                   : x;
  if (s <= nt && s - 1 == k)
    return norm.on ? 2.0f / (norm.ub[k] - norm.lb[k]) : 1.0f;
  return 0.0f;
}

}  // namespace
