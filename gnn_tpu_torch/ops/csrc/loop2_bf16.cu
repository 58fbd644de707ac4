// K10_bf16, the two-layer eval loop on a bf16 block adjacency, for Hopper
// (sm_90a): all K iterations of residual-free blocks, bf16.cuh's iteration
// (gnn_tpu's hp = False rounding) with the adjacency staged once a launch.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K10 _loop2_kernel_T with a bf16 adjacency (hp false, launched by
//   _loop2_impl) -> gnn_propagation_loop2_bf16
// K9's bf16 variant is in fused2_bf16.cu, K11's in eval_loop2_bwd_bf16.cu;
// the f32 K10 in loop2.cu.
//
// Dataflow: gnn_tpu's. The f32 K10 aggregates the D-wide state first; here
// the H1-wide bf(U_a) rows are aggregated (2*W*W*H1 operations a block and
// iteration, H1/D of the f32 kernel's), as the rounding sits on U_a.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block), s0, fT
// [W][H1] and the K states and margins; the operations 2*W*(2H1*D + W*H1 +
// H1*D) a block and iteration at the card's dense bf16 tensor-core rate
// (chip_smoke.py::bf16_bounds). This simple kernel multiplies on the CUDA
// cores in f32 (the same products, each exact), so it runs far from that
// bound; tensor cores (mma.sync bf16 with f32 accumulation) are the later
// redesign's.
//
// Margins: margins[k] = nm where the node moved before iteration k,
// ||s_k - s_{k-1}|| > thr * ||s_{k-1}||, s_{-1} = 1.

#include "bf16.cuh"

namespace {

using namespace gnn;

__global__ void __launch_bounds__(kBf16Threads)
loop2_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                  const float* __restrict__ fT, const float* __restrict__ w20,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ aff, const float* __restrict__ nm,
                  float* __restrict__ traj, float* __restrict__ marg, int B, int W, int D,
                  int H1, int K, float thr, int act0, int act1) {
  extern __shared__ float4 smem_f4[];
  const Bf16Smem m = bf16_layout(smem_f4, W, D, false);
  const int b = blockIdx.x;
  bf16_stage(m, adjT, s0, b, W, D);
  __syncthreads();
  // margins[0]: s0 against ones
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    float dist = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float e = m.s[n * D + d] - 1.0f;
      dist += e * e;
    }
    marg[(size_t)b * W + n] =
        sqrtf(dist) > thr * sqrtf((float)D) ? nm[(size_t)b * W + n] : 0.0f;
  }
  for (int k = 0; k < K; ++k) {
    bf16_iteration(m, fT, nullptr, w20, w1, b1, aff, b, W, D, H1, act0, act1);
    float* out = traj + ((size_t)k * B + b) * W * D;
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) out[i] = m.h1[i];
    if (k + 1 < K) {
      for (int n = threadIdx.x; n < W; n += blockDim.x) {
        float dist = 0.0f, norm = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float o = m.s[n * D + d], e = m.h1[n * D + d] - o;
          dist += e * e;
          norm += o * o;
        }
        marg[((size_t)(k + 1) * B + b) * W + n] =
            sqrtf(dist) > thr * sqrtf(norm) ? nm[(size_t)b * W + n] : 0.0f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) m.s[i] = m.h1[i];
  }
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 [B, W, D], fT [B, W, H1], w20 [2H1, D], w1 [D, H1],
// b1 [D], aff [2, D], nm [B, W] -> traj [K, B, W, D], marg [K, B, W].
// Returns a cudaError_t code.
int gnn_propagation_loop2_bf16(const uint16_t* adjT, const float* s0, const float* fT,
                               const float* w20, const float* w1, const float* b1,
                               const float* aff, const float* nm, float* traj, float* marg,
                               int B, int W, int D, int H1, int K, float thr, int act0, int act1,
                               void* stream) {
  if (!block_ok(B, W) || D <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t bytes = bf16_smem(W, D, false);
  cudaError_t err = set_smem(loop2_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  loop2_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, fT, w20, w1, b1, aff, nm, traj, marg, B, W, D, H1, K, thr, act0, act1);
  return cudaGetLastError();
}

}  // extern "C"
