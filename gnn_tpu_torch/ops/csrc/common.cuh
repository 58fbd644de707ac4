// Device helpers shared by the port's propagation kernels (fused_eval.cu,
// eval_loop.cu, bn_fwd.cu, bn_train.cu, eval_loop_bwd.cu, train_loop.cu,
// train_loop_bwd.cu, fused2.cu, loop2.cu, train_loop2_bwd.cu,
// eval_loop2_bwd.cu, bn2_fwd.cu, bn2_train.cu, bn_typed.cu): the activations
// of the Pallas kernels, the input dropout and its derivative, and the
// staging of block adjacencies and row blocks between device and shared
// memory and the dense column contraction (stage_adj, stage_in, stage_out,
// aggregate_col) of the one kernel still per-node, K6 (train_loop.cu). The
// redesigned kernels build on tile2.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gnn {

constexpr int kMaxW = 128;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a CTA may use
// the value alpha-dropped units saturate to: -SELU_ALPHA * SELU_SCALE
constexpr float kAlphaP = -1.7580993408473766f;

enum Activation { kLinear = 0, kTanh = 1, kRelu = 2, kSelu = 3 };
enum DropMode { kNoDrop = 0, kAlphaDrop = 1, kStdDrop = 2 };

__device__ __forceinline__ float activate(int act, float x) {
  switch (act) {
    case kTanh:
      return tanhf(x);
    case kRelu:
      return fmaxf(x, 0.0f);
    case kSelu:
      // exp(min(x, 0)) - 1, not expm1: the formula of pallas_fused.py::_ACTS
      return 1.0507009873554805f *
             (x > 0.0f ? x : 1.6732632423543772f * (expf(fminf(x, 0.0f)) - 1.0f));
    default:
      return x;
  }
}

__device__ __forceinline__ float act_grad(int act, float h) {
  switch (act) {
    case kTanh: {
      const float t = tanhf(h);
      return 1.0f - t * t;
    }
    case kRelu:
      return h > 0.0f ? 1.0f : 0.0f;
    case kSelu:
      return h > 0.0f ? 1.0507009873554805f
                      : 1.0507009873554805f * 1.6732632423543772f * expf(fminf(h, 0.0f));
    default:
      return 1.0f;
  }
}

// The input dropout of ops/mlp.py::_dropout from a keep bit:
// alpha a * (keep ? x : alpha') + b, standard keep ? a * x : 0.
__device__ __forceinline__ float drop(int mode, float a, float b, float x, bool keep) {
  if (mode == kAlphaDrop) return a * (keep ? x : kAlphaP) + b;
  if (mode == kStdDrop) return keep ? a * x : 0.0f;
  return x;
}

// d drop(x) / dx: a * keep, or 1 without dropout.
__device__ __forceinline__ float drop_grad(int mode, float a, bool keep) {
  return mode == kNoDrop ? 1.0f : (keep ? a : 0.0f);
}

// Block adjacency [W, W] (contiguous, 16-byte aligned) -> rows of stride W + 1,
// so a thread per destination reading a column and a thread per source reading
// a row are both free of bank conflicts.
__device__ inline void stage_adj(const float* __restrict__ g, int W, float* sm) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < W * W / 4; i += blockDim.x) {
    const float4 v = g4[i];
    float* d = sm + (4 * i / W) * (W + 1) + 4 * i % W;  // W % 4 == 0: no row crossing
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Contiguous [W, F] rows -> shared rows of stride P, from column c0.
__device__ inline void stage_in(const float* __restrict__ g, int W, int F, float* sm, int P,
                                int c0) {
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) sm[(i / F) * P + c0 + i % F] = g[i];
}

// Shared rows of stride P -> contiguous [W, F] rows.
__device__ inline void stage_out(float* __restrict__ g, int W, int F, const float* sm, int P) {
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) g[i] = sm[(i / F) * P + i % F];
}

// agg[t] = sum_src adjT[src][t] * rows[src] (rows of stride P), reading column
// t of the adjacency staged by stage_adj.
template <int MAXF>
__device__ void aggregate_col(const float* adj, int W, const float* rows, int P, int D,
                              float (&acc)[MAXF]) {
#pragma unroll
  for (int d = 0; d < MAXF; ++d) acc[d] = 0.0f;
  for (int src = 0; src < W; ++src) {
    const float a = adj[src * (W + 1) + threadIdx.x];
    const float* r = rows + src * P;
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) acc[d] = fmaf(a, r[d], acc[d]);
  }
}

// The BatchNorm kernels' rows: block row blockIdx.x < Bl reads adj_loop[r],
// the rest adj_dep[r - Bl], where they lie.
__device__ inline const float* block_adj(const float* adj_loop, const float* adj_dep, int Bl,
                                         int W) {
  const int r = blockIdx.x;
  return r < Bl ? adj_loop + (size_t)r * W * W : adj_dep + (size_t)(r - Bl) * W * W;
}

// Register-array width for a feature width: 16, 32 or 64 (0 = unsupported).
inline int width_class(int F) { return F <= 16 ? 16 : F <= 32 ? 32 : F <= 64 ? 64 : 0; }

inline bool block_ok(int B, int W) { return B > 0 && W >= 32 && W <= kMaxW && W % 32 == 0; }

// Opt a kernel in to `bytes` of dynamic shared memory (refused above 227 KB).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gnn
