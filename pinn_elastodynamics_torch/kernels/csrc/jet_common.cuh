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

// Widest hidden layer and largest weight matrix of a net.
void net_sizes(const Net& net, int* hid, int* wmax, int* bmax) {
  for (int l = 0; l < net.n_layers; ++l) {
    if (l > 0) *hid = std::max(*hid, net.dims[l]);
    *wmax = std::max(*wmax, net.dims[l] * net.dims[l + 1]);
    *bmax = std::max(*bmax, net.dims[l + 1]);
  }
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
