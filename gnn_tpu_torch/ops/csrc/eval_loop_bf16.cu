// K3_bf16 and K4_bf16, the one-layer eval kernels on a bf16 block adjacency,
// for Hopper (sm_90a): gnn_tpu's `hp = False` branch of _iter_core
// (pallas_fused.py:213-216), one iteration on a block of W nodes, node-major,
// w2 = [Ws; Wa] [2H, D], bf as in bf16.cuh:
//   U  = bf(s) @ bf(w2)^T                   [W, 2H]
//   A  = adjT^T @ bf(U_a)                   over the sources ascending
//   s' = act((U_s + A) + fT (+ rT)) * scale + shift
// the first layer of bf16.cuh's iteration with H = D, its activation through
// act64 and the affine (multiply, then add) in place of the second layer.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K3 _loop_kernel_T with a bf16 adjacency (hp false, launched by
//      _fused_loop_impl) -> gnn_propagation_loop_bf16
//   K4 _step_kernel_T with a bf16 adjacency (hp false, launched by
//      _fused_fwd_impl) -> gnn_propagation_step_bf16
// The f32 K3 is in eval_loop.cu, K4 in fused_eval.cu. gnn_tpu's K4 backward
// on a bf16 batch is XLA in f32 (the clean training route), not ported here.
//
// Design: bf16.cuh's CTA, one a block, the bf16 adjacency staged once a
// launch (K3 runs all K iterations on it), the H outputs in chunks of
// kBf16Chunk: U's two halves of the chunk, then A and act64, then the
// affine. K3's new state goes to the h1 rows [W][D] (H = D) until every
// chunk has read s; K4 writes its [W][H] output directly. No atomics: a
// repeat launch is bit-identical, and every sum runs in the plain version's
// order (ops/fused.py::propagation_{loop,step}_bf16_ref), so a launch gives
// its bits.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block), the f32 rows
// (s, fT, rT, the K states and margins) once; the operations 2*W*(2H*D +
// H*D) a block and iteration plus 2*H an arc at the dense bf16 tensor-core
// rate (chip_smoke.py::bf16_bounds). This simple kernel multiplies on the
// CUDA cores in f32 (the same exact products) over the dense adjacency, so
// it runs far from that bound; tensor-core tiles are a later redesign's.
//
// Margins (K3): margins[k] = nm where the node moved before iteration k,
// ||s_k - s_{k-1}|| > thr * ||s_{k-1}||, s_{-1} = 1.

#include "bf16.cuh"

namespace {

using namespace gnn;

// One iteration from m.s: act((U_s + A) + fT (+ rT)) * aff[0] + aff[1] into
// out [W][H] (K3: m.h1, K4: the block's output rows).
__device__ void eval_iteration(const Bf16Smem& m, const float* __restrict__ fT,
                               const float* __restrict__ rT, const float* __restrict__ w2,
                               const float* __restrict__ aff, int b, int W, int D, int H,
                               int act, float* out) {
  for (int h0 = 0; h0 < H; h0 += kBf16Chunk) {
    const int cw = min(kBf16Chunk, H - h0);
    __syncthreads();  // s ready; the last chunk's affine read c0
    bf16_u_chunk(m, w2, W, D, H, h0, cw);
    __syncthreads();
    bf16_h0_chunk(m, fT, rT, b, W, H, h0, cw, act, nullptr, m.c0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
      const int n = i / cw, h = h0 + i % cw;
      out[n * H + h] = __fadd_rn(__fmul_rn(m.c0[n * kBf16Chunk + i % cw], __ldg(aff + h)),
                                 __ldg(aff + H + h));
    }
  }
  __syncthreads();
}

// margins of block b before the next iteration: s_old in `old` (null: ones)
__device__ void margins(const float* s, const float* old, const float* __restrict__ nm,
                        float* marg, int b, int W, int D, float thr) {
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    float dist = 0.0f, norm = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float o = old == nullptr ? 1.0f : old[n * D + d], e = s[n * D + d] - o;
      dist += e * e;
      norm += o * o;
    }
    marg[n] = sqrtf(dist) > thr * sqrtf(norm) ? nm[(size_t)b * W + n] : 0.0f;
  }
}

__global__ void __launch_bounds__(kBf16Threads)
loop_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                 const float* __restrict__ fT, const float* __restrict__ w2,
                 const float* __restrict__ aff, const float* __restrict__ nm,
                 float* __restrict__ traj, float* __restrict__ marg, int B, int W, int D, int K,
                 float thr, int act) {
  extern __shared__ float4 smem_f4[];
  const Bf16Smem m = bf16_layout(smem_f4, W, D, false);
  const int b = blockIdx.x;
  bf16_stage(m, adjT, s0, b, W, D);
  __syncthreads();
  margins(m.s, nullptr, nm, marg + (size_t)b * W, b, W, D, thr);
  for (int k = 0; k < K; ++k) {
    eval_iteration(m, fT, nullptr, w2, aff, b, W, D, D, act, m.h1);
    float* o = traj + ((size_t)k * B + b) * W * D;
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) o[i] = m.h1[i];
    if (k + 1 < K) margins(m.h1, m.s, nm, marg + ((size_t)(k + 1) * B + b) * W, b, W, D, thr);
    __syncthreads();
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) m.s[i] = m.h1[i];
  }
}

__global__ void __launch_bounds__(kBf16Threads)
step_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s,
                 const float* __restrict__ rT, const float* __restrict__ fT,
                 const float* __restrict__ w2, const float* __restrict__ aff,
                 float* __restrict__ out, int W, int D, int H, int act) {
  extern __shared__ float4 smem_f4[];
  const Bf16Smem m = bf16_layout(smem_f4, W, D, false);
  const int b = blockIdx.x;
  bf16_stage(m, adjT, s, b, W, D);
  eval_iteration(m, fT, rT, w2, aff, b, W, D, H, act, out + (size_t)b * W * H);
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 and fT [B, W, D], w2 [2D, D], aff [2, D], nm
// [B, W] -> traj [K, B, W, D], marg [K, B, W]. Returns a cudaError_t code.
int gnn_propagation_loop_bf16(const uint16_t* adjT, const float* s0, const float* fT,
                              const float* w2, const float* aff, const float* nm, float* traj,
                              float* marg, int B, int W, int D, int K, float thr, int act,
                              void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t bytes = bf16_smem(W, D, false);
  cudaError_t err = set_smem(loop_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  loop_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, fT, w2, aff, nm, traj, marg, B, W, D, K, thr, act);
  return cudaGetLastError();
}

// adjT bf16 [B, W, W], s [B, W, D], rT [B, W, H] (nullable), fT [B, W, H],
// w2 [2H, D], aff [2, H] -> out [B, W, H]. Returns a cudaError_t code.
int gnn_propagation_step_bf16(const uint16_t* adjT, const float* s, const float* rT,
                              const float* fT, const float* w2, const float* aff, float* out,
                              int B, int W, int D, int H, int act, void* stream) {
  if (!block_ok(B, W) || D <= 0 || H <= 0) return cudaErrorInvalidValue;
  const size_t bytes = bf16_smem(W, D, false);
  cudaError_t err = set_smem(step_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  step_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s, rT, fT, w2, aff, out, W, D, H, act);
  return cudaGetLastError();
}

}  // extern "C"
