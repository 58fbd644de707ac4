// Device helpers shared by the port's propagation kernels (fused_eval.cu,
// eval_loop.cu, bn_fwd.cu, bn_train.cu, eval_loop_bwd.cu, train_loop.cu,
// train_loop_bwd.cu, fused2.cu, loop2.cu, train_loop2_bwd.cu,
// eval_loop2_bwd.cu, bn2_fwd.cu, bn2_train.cu, bn_typed.cu): the activations
// of the Pallas kernels, the input dropout and its derivative, and the
// launch checks. The kernels' staging, adjacency lists and block products
// are in tile2.cuh.

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

// The BatchNorm kernels' rows: block row blockIdx.x < Bl reads adj_loop[r],
// the rest adj_dep[r - Bl], where they lie.
__device__ inline const float* block_adj(const float* adj_loop, const float* adj_dep, int Bl,
                                         int W) {
  const int r = blockIdx.x;
  return r < Bl ? adj_loop + (size_t)r * W * W : adj_dep + (size_t)(r - Bl) * W * W;
}

// Register-array width for a feature width: 16, 32 or 64 (0: above 64, which
// the staged plans of K9-K17 do not take; their wide plans take every width).
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
