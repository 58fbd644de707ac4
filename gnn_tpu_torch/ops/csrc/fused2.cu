// Two-layer propagation kernels of the GNN fixed-point loop for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16): a state net
// dense0 -> act0 -> dense1 -> act1 with a hidden width H1 (the hidden-150
// accuracy recipe), forward passes.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K9  _step2_kernel_T       (launched by _step2_impl)       -> gnn_propagation_step2
//   K12 _loop2_train_kernel_T (launched by _loop2_train_impl) -> gnn_train_loop2
// K12's reverse, K13, is in train_loop2_bwd.cu; K10, the eval loop, in
// loop2.cu.
//
// One iteration on one W-node block, node-major rows:
//   agg = adjT^T @ s (+ rT)              agg[dst] = sum_src adjT[src, dst] * s[src]
//   x3  = [drop(s) | drop(agg) | f]      2D + AL wide; f the arc-label aggregation
//   y0  = act0(w0 @ x3 + b0)             w0 = [Ws | Wa | Wf], [H1, 2D + AL]
//   s'  = act1(w1 @ y0 + b1) (* scale + shift)
// gnn_tpu's kernels multiply first and contract the adjacency H1 wide
// (2*W*W*H1 flops a block and iteration) and read a hoisted H1-wide feature
// term Wf @ f + b0; these aggregate the D-wide state (2*W*W*D flops, the same
// linear map) and form the feature term from f's AL columns, reading AL/H1 of
// those bytes.
// K12 runs the K dropout-training iterations of a residual-free block (f =
// fd[k], the dropped arc-label aggregation of iteration k; the state and
// aggregated slices dropped here from uint8 keep-masks), writing the state
// after every iteration (traj), the pre-update movement flags and every
// pre-dropout aggregation (saved for K13). K9 runs one eval iteration of a
// residual-coupled block; rT is the raw residual aggregation, added to agg.
//
// Design: one CTA per block, one thread per node (blockDim == W), as in
// train_loop.cu. The adjacency is staged in shared memory with row stride
// W + 1 and read by columns. The weights w0, w1 (transposed) and the biases
// sit in shared memory; every thread reads the same weight at the same time (a
// broadcast). A thread holds its node's x3 in registers (MAXF-wide arrays, D
// and AL <= MAXF) and loops over the H1 hidden units: h0_j, act0, and
// h1 += w1[:, j] * y0_j at once (common.cuh::dense2_h1), so no H1-wide row is
// stored anywhere. At W = 128, D = 14, AL = 3, H1 = 150 a CTA takes 109 KB: two
// fit an SM.
//
// Bound: the dense layers cost 2*H1*(3D + AL) flops a node and iteration
// (13.5 kflop on the recipe) against 10*D + 4*AL + 4 bytes a node and
// iteration moved by K12 (state, flag, masks, fd, agg): the least time is set by the operations at the card's fp32 rate.
// This first version does the dense adjacency contraction (2*D*W*W flops a
// block and iteration, about a third of the dense layers' at H1 = 150) and
// three dependent h0 sums per hidden unit per thread, with 8 warps an SM.

#include "common.cuh"

namespace {

using namespace gnn;

// Floats of shared memory of the forward kernels: the adjacency, the block's
// state rows, a staging tile and the weights (fused2.py::_smem_bytes mirrors it).
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

// K12: all K dropout-training iterations of residual-free blocks; reads fd
// [K, B, W, AL], the keep-masks ms/ma (null without dropout) and writes agg.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
train_loop2_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
             const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
             const float* __restrict__ f, const float* __restrict__ w0,
             const float* __restrict__ b0, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ nm,
             float* __restrict__ traj, float* __restrict__ marg,
             float* __restrict__ agg_out, int B, int W, int D, int AL, int H1, int K, float thr,
             int act0, int act1, int mode, float da, float db) {
  extern __shared__ float4 smem_raw[];
  const Fwd m = carve(reinterpret_cast<float*>(smem_raw), W, D, AL, H1);
  const int DP = D | 1, RP = (D > AL ? D : AL) | 1;
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;

  stage_adj(adjT + row0 * W, W, m.adj);
  stage_dense2(w0, 2 * D + AL, b0, 1, w1, b1, D, 2 * D + AL, H1, m.w0, m.b0, m.w1T, m.b1);
  stage_in(s0 + row0 * D, W, D, m.S, DP, 0);
  __syncthreads();
  float s[MAXF], s_old[MAXF], xs[MAXF], a[MAXF], xf[MAXF], h1[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    s[d] = d < D ? m.S[t * DP + d] : 0.0f;
    s_old[d] = 1.0f;
    xf[d] = 0.0f;
  }
  const float nmv = nm[row0 + t];

  for (int k = 0; k < K; ++k) {
    const size_t kb = (size_t)k * B + b;  // block b of iteration k in [K, B, ...]
    // movement test before update k: ||s - s_old|| > thr * ||s_old||
    float dist2 = 0.0f, norm2 = 0.0f;
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      if (d < D) {
        const float diff = s[d] - s_old[d];
        dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
        norm2 = __fadd_rn(norm2, __fmul_rn(s_old[d], s_old[d]));
      }
    }
    marg[kb * W + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nmv : 0.0f;

    aggregate_col<MAXF>(m.adj, W, m.S, DP, D, a);
    __syncthreads();  // every thread is past its reads of S (and of R)
#pragma unroll
    for (int d = 0; d < MAXF; ++d) xs[d] = s[d];
    {
#pragma unroll
      for (int d = 0; d < MAXF; ++d)
        if (d < D) m.R[t * RP + d] = a[d];
      __syncthreads();
      stage_out(agg_out + kb * W * D, W, D, m.R, RP);
      __syncthreads();
      stage_in(f + kb * W * AL, W, AL, m.R, RP, 0);
      __syncthreads();
      const uint8_t* ks = mode != kNoDrop ? ms + (kb * W + t) * D : nullptr;
      const uint8_t* ka = mode != kNoDrop ? ma + (kb * W + t) * D : nullptr;
#pragma unroll
      for (int d = 0; d < MAXF; ++d) {
        xf[d] = d < AL ? m.R[t * RP + d] : 0.0f;
        if (d < D) {
          xs[d] = drop(mode, da, db, s[d], ks != nullptr && ks[d] != 0);
          a[d] = drop(mode, da, db, a[d], ka != nullptr && ka[d] != 0);
        }
      }
    }
    dense2_h1<MAXF>(m.w0, m.b0, m.w1T, m.b1, D, AL, H1, act0, xs, a, xf, h1);
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      s_old[d] = s[d];
      const float y = d < D ? activate(act1, h1[d]) : 0.0f;
      s[d] = y;
      if (d < D) m.S[t * DP + d] = y;
    }
    __syncthreads();
    stage_out(traj + kb * W * D, W, D, m.S, DP);
  }
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
cudaError_t launch_loop2(const float* adjT, const float* s0, const uint8_t* ms, const uint8_t* ma,
                         const float* f, const float* w0, const float* b0, const float* w1,
                         const float* b1, const float* nm, float* traj, float* marg, float* agg,
                         int B, int W, int D, int AL, int H1, int K, float thr, int act0,
                         int act1, int mode, float da, float db, cudaStream_t stream) {
  const size_t bytes = fwd_smem(W, D, AL, H1);
  cudaError_t err = set_smem(train_loop2_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  train_loop2_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s0, ms, ma, f, w0, b0, w1, b1, nm, traj,
                                                    marg, agg, B, W, D, AL, H1, K, thr, act0,
                                                    act1, mode, da, db);
  return cudaGetLastError();
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

// adjT [B, W, W], s0 [B, W, D], ms/ma uint8 [K, B, W, D] (null when mode == 0),
// fd [K, B, W, AL], w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D], nm [B, W]
// -> traj, agg [K, B, W, D], marg [K, B, W]. Returns a cudaError_t code.
int gnn_train_loop2(const float* adjT, const float* s0, const uint8_t* ms, const uint8_t* ma,
                    const float* fd, const float* w0, const float* b0, const float* w1,
                    const float* b1, const float* nm, float* traj, float* marg, float* agg, int B,
                    int W, int D, int AL, int H1, int K, float thr, int act0, int act1, int mode,
                    float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (mode != kNoDrop && (ms == nullptr || ma == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return launch_loop2<16>(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, traj, marg, agg, B, W, D,
                              AL, H1, K, thr, act0, act1, mode, da, db, st);
    case 32:
      return launch_loop2<32>(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, traj, marg, agg, B, W, D,
                              AL, H1, K, thr, act0, act1, mode, da, db, st);
    case 64:
      return launch_loop2<64>(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, traj, marg, agg, B, W, D,
                              AL, H1, K, thr, act0, act1, mode, da, db, st);
    default:
      return cudaErrorInvalidValue;
  }
}

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
