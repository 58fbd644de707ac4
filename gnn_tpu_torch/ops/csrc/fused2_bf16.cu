// K9_bf16, one two-layer eval iteration on a bf16 block adjacency, for
// Hopper (sm_90a): residual-coupled blocks, bf16.cuh's iteration (gnn_tpu's
// hp = False rounding) with the f32 residual term rT = W0a @ Σres, H1 wide,
// added after the feature term as gnn_tpu adds it.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K9 _step2_kernel_T with a bf16 adjacency (hp false, launched by
//   _step2_impl) -> gnn_propagation_step2_bf16
// Its backward is gnn_tpu's _step2_bwd, an f32 recompute (ops/fused2.py
// _step2_bf16_vjp); the f32 K9 is in fused2.cu.
//
// Bound: as K10_bf16's for one iteration, with rT's bytes
// (chip_smoke.py::bf16_bounds).

#include "bf16.cuh"

namespace {

using namespace gnn;

__global__ void __launch_bounds__(kBf16Threads)
step2_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s,
                  const float* __restrict__ rT, const float* __restrict__ fT,
                  const float* __restrict__ w20, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ aff,
                  float* __restrict__ out, int W, int D, int H1, int act0, int act1) {
  extern __shared__ float4 smem_f4[];
  const Bf16Smem m = bf16_layout(smem_f4, W, D, false);
  const int b = blockIdx.x;
  bf16_stage(m, adjT, s, b, W, D);
  bf16_iteration(m, fT, rT, w20, w1, b1, aff, b, W, D, H1, act0, act1);
  float* o = out + (size_t)b * W * D;
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) o[i] = m.h1[i];
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s [B, W, D], rT [B, W, H1] (nullable), fT [B, W, H1],
// w20 [2H1, D], w1 [D, H1], b1 [D], aff [2, D] -> out [B, W, D]. Returns a
// cudaError_t code.
int gnn_propagation_step2_bf16(const uint16_t* adjT, const float* s, const float* rT,
                               const float* fT, const float* w20, const float* w1,
                               const float* b1, const float* aff, float* out, int B, int W,
                               int D, int H1, int act0, int act1, void* stream) {
  if (!block_ok(B, W) || D <= 0 || H1 <= 0) return cudaErrorInvalidValue;
  const size_t bytes = bf16_smem(W, D, false);
  cudaError_t err = set_smem(step2_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  step2_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s, rT, fT, w20, w1, b1, aff, out, W, D, H1, act0, act1);
  return cudaGetLastError();
}

}  // extern "C"
