// K9, one iteration of the two-layer eval step, for Hopper (sm_90a), in
// plain fp32 on the CUDA cores (no TF32, no bf16): a state net dense0 ->
// act0 -> dense1 -> act1 with a hidden width H1 (the hidden-150 accuracy
// recipe).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K9  _step2_kernel_T (launched by _step2_impl) -> gnn_propagation_step2
// K10 (the eval loop) and K12 (the dropout-training loop) are in loop2.cu,
// K12's reverse, K13, in train_loop2_bwd.cu.
//
// One iteration on one W-node block of a residual-coupled block, node-major
// rows; rT is the raw residual aggregation, added to agg:
//   agg = adjT^T @ s + rT                agg[dst] = sum_src adjT[src, dst] * s[src]
//   x3  = [s | agg | f]                  2D + AL wide; f the arc-label aggregation
//   y0  = act0(w0 @ x3 + b0)             w0 = [Ws | Wa | Wf], [H1, 2D + AL]
//   s'  = act1(w1 @ y0 + b1) * scale + shift
// gnn_tpu's kernel multiplies first and contracts the adjacency H1 wide
// (2*W*W*H1 flops a block) and reads a hoisted H1-wide feature term
// Wf @ f + b0; this aggregates the D-wide state (2*W*W*D flops, the same
// linear map) and forms the feature term from f's AL columns, reading AL/H1
// of those bytes.
//
// Design: one CTA per block, one thread per node (blockDim == W). The
// adjacency is staged in shared memory with row stride W + 1 and read by
// columns. The weights w0, w1 (transposed) and the biases sit in shared
// memory; every thread reads the same weight at the same time (a broadcast).
// A thread holds its node's x3 in registers (MAXF-wide arrays, D and AL <=
// MAXF) and loops over the H1 hidden units: h0_j, act0, and h1 += w1[:, j] *
// y0_j at once (common.cuh::dense2_h1), so no H1-wide row is stored
// anywhere. At W = 128, D = 14, AL = 3, H1 = 150 a CTA takes 109 KB: two fit
// an SM.
//
// Bound: the dense layers cost 2*H1*(3D + AL) flops a node against
// 8*D + 4*AL bytes a node: the least time is set by the operations at the
// card's fp32 rate. This version does the dense adjacency contraction
// (2*D*W*W flops a block, about a third of the dense layers' at H1 = 150) and
// three dependent h0 sums per hidden unit per thread, with 8 warps an SM.

#include "common.cuh"

namespace {

using namespace gnn;

// Floats of shared memory of K9: the adjacency, the block's state rows, a
// staging tile and the weights (fused2.py::_smem_bytes mirrors it).
size_t fwd_smem(int W, int D, int AL, int H1) {
  const int C = 2 * D + AL;
  return sizeof(float) * ((size_t)W * (W + 1) + (size_t)W * (D | 1) +
                          (size_t)W * ((D > AL ? D : AL) | 1) + (size_t)H1 * (C + D + 1) +
                          3 * (size_t)D);
}

struct Fwd {
  float* adj;   // [W][W + 1]
  float* S;     // [W][D | 1] the block's state
  float* R;     // [W][max(D, AL) | 1] staging
  float* w0;    // [H1][C]
  float* b0;    // [H1]
  float* w1T;   // [H1][D]
  float* b1;    // [D]
  float* aff;   // [2][D] scale; shift
};

__device__ Fwd carve(float* base, int W, int D, int AL, int H1) {
  Fwd m;
  m.adj = base;
  m.S = m.adj + W * (W + 1);
  m.R = m.S + W * (D | 1);
  m.w0 = m.R + W * ((D > AL ? D : AL) | 1);
  m.b0 = m.w0 + H1 * (2 * D + AL);
  m.w1T = m.b0 + H1;
  m.b1 = m.w1T + H1 * D;
  m.aff = m.b1 + D;
  return m;
}

// K9: one eval iteration of residual-coupled blocks; rT [B, W, D] nullable.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
step2_kernel(const float* __restrict__ adjT, const float* __restrict__ s,
             const float* __restrict__ rT, const float* __restrict__ f,
             const float* __restrict__ w0, const float* __restrict__ b0,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ aff, float* __restrict__ out, int W, int D, int AL, int H1,
             int act0, int act1) {
  extern __shared__ float4 smem_raw[];
  const Fwd m = carve(reinterpret_cast<float*>(smem_raw), W, D, AL, H1);
  const int DP = D | 1, RP = (D > AL ? D : AL) | 1;
  const int t = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * W;

  stage_adj(adjT + row0 * W, W, m.adj);
  stage_dense2(w0, 2 * D + AL, b0, 1, w1, b1, D, 2 * D + AL, H1, m.w0, m.b0, m.w1T, m.b1);
  for (int i = t; i < 2 * D; i += blockDim.x) m.aff[i] = aff[i];
  stage_in(s + row0 * D, W, D, m.S, DP, 0);
  stage_in(f + row0 * AL, W, AL, m.R, RP, 0);
  __syncthreads();
  float xs[MAXF], a[MAXF], xf[MAXF], h1[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    xs[d] = d < D ? m.S[t * DP + d] : 0.0f;
    xf[d] = d < AL ? m.R[t * RP + d] : 0.0f;
  }
  aggregate_col<MAXF>(m.adj, W, m.S, DP, D, a);
  __syncthreads();  // every thread is past its reads of S and R
  if (rT != nullptr) {
    stage_in(rT + row0 * D, W, D, m.R, RP, 0);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) a[d] += m.R[t * RP + d];
  }
  dense2_h1<MAXF>(m.w0, m.b0, m.w1T, m.b1, D, AL, H1, act0, xs, a, xf, h1);
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    if (d < D) m.S[t * DP + d] = activate(act1, h1[d]) * m.aff[d] + m.aff[D + d];
  __syncthreads();
  stage_out(out + row0 * D, W, D, m.S, DP);
}

template <int MAXF>
cudaError_t launch_step2(const float* adjT, const float* s, const float* rT, const float* f,
                         const float* w0, const float* b0, const float* w1, const float* b1,
                         const float* aff, float* out, int B, int W, int D, int AL, int H1,
                         int act0, int act1, cudaStream_t stream) {
  const size_t bytes = fwd_smem(W, D, AL, H1);
  cudaError_t err = set_smem(step2_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  step2_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s, rT, f, w0, b0, w1, b1, aff, out, W, D, AL,
                                              H1, act0, act1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// adjT [B, W, W], s [B, W, D], rT [B, W, D] (nullable), f [B, W, AL],
// w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D], aff [2, D] -> out [B, W, D].
// Returns a cudaError_t code.
int gnn_propagation_step2(const float* adjT, const float* s, const float* rT, const float* f,
                          const float* w0, const float* b0, const float* w1, const float* b1,
                          const float* aff, float* out, int B, int W, int D, int AL, int H1,
                          int act0, int act1, void* stream) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return launch_step2<16>(adjT, s, rT, f, w0, b0, w1, b1, aff, out, B, W, D, AL, H1, act0,
                              act1, st);
    case 32:
      return launch_step2<32>(adjT, s, rT, f, w0, b0, w1, b1, aff, out, B, W, D, AL, H1, act0,
                              act1, st);
    case 64:
      return launch_step2<64>(adjT, s, rT, f, w0, b0, w1, b1, aff, out, B, W, D, AL, H1, act0,
                              act1, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
