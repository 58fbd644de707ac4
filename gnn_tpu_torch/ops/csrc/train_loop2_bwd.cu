// Reverse of the two-layer dropout-training loop for Hopper (sm_90a), in
// plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K13 _loop2_train_bwd_kernel (launched by _loop2_train_bwd_impl) -> gnn_train_loop2_bwd
//
// The K reverse iterations of K12 (fused2.cu) on one W-node block; reverse
// step k, from the saved state traj[k-1] (s0) and pre-dropout aggregation agg[k]:
//   x3  = [drop(s, ms) | drop(agg, ma) | fd[k]],  h0 = w0 @ x3 + b0,
//   y0  = act0(h0),  h1 = w1 @ y0 + b1            recomputed
//   dh1 = (g_traj[k] + gs) * act1'(h1)            -> db1, dw1 += dh1 (x) y0
//   dh0 = (w1^T @ dh1) * act0'(h0)                -> db0, dw0 += dh0 (x) x3
//   dx3 = w0^T @ dh0                              -> dfd[k] = dx3[2D:]
//   gs  = dx3[:D] * a*ms + adjT @ (dx3[D:2D] * a*ma)
//
// Design: one CTA per block, one thread per node (blockDim == W). Shared
// memory holds the weights, every node's x3 row and its dh1 row. A thread
// first loops over the H1 hidden units to rebuild its h1 and dh1
// (common.cuh::dense2_h1), then again in chunks of kChunk units
// (common.cuh::bwd2_hidden, shared with K11 and K15): it recomputes h0_j and
// y0_j, forms dh0_j, adds w0[j] * dh0_j into its dx3, and writes y0 and dh0 of
// the chunk into two [W][kChunk] tiles. A [W][H1] block of y0 or dh0 would
// take 76.8 KB at W = 128, H1 = 150; the tiles take 8.7 KB each. After each
// chunk the CTA sums the chunk's dw0, db0 and dw1 entries over the block's
// nodes from the tiles and the x3/dh1 rows; each entry belongs to one thread,
// the same in every reverse step, which accumulates the block's partial in
// device memory (no atomics: a result does not vary between runs; torch sums
// the per-block partials in a fixed order). dfd[k] is written straight from
// registers. The adjacency is read once a reverse step, by rows, for the
// dagg -> gs contraction: it is staged 32 columns at a time through the tiles
// (common.cuh::contract_rows) rather than kept in shared memory, so a CTA
// takes 68.6 KB at W = 128, H1 = 150 and two fit an SM (168 registers a thread).
//
// Bound: the function needs 2*H1*(9D + 3AL + 1) flops a node and reverse step
// (41 kflop on the recipe: the forward recomputed once, the reverse dense
// layers, the weight-gradient sums) against about 14*D + 8*AL bytes a node
// and step (the saved rows, the masks, the cotangents): the least time is set
// by the operations at the card's fp32 rate. This first version does
// 2*H1*(11D + 4AL + 1) (it recomputes h0 a second time), runs 8 warps an SM,
// and its weight-gradient sums read both operands from shared memory.

#include "common.cuh"

namespace {

using namespace gnn;

// Floats of shared memory (fused2.py::_smem_bytes mirrors it).
size_t bwd_smem(int W, int D, int AL, int H1) {
  return sizeof(float) * bwd2_floats(W, D, 2 * D + AL, H1);
}

template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
train_loop2_bwd_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                       const float* __restrict__ traj, const float* __restrict__ agg,
                       const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                       const float* __restrict__ fd, const float* __restrict__ w0,
                       const float* __restrict__ b0, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ g_traj,
                       float* __restrict__ gs_out, float* __restrict__ dw0_out,
                       float* __restrict__ db0_out, float* __restrict__ dw1_out,
                       float* __restrict__ db1_out, float* __restrict__ dfd, int B, int W, int D,
                       int AL, int H1, int K, int act0, int act1, int mode, float da, float db) {
  extern __shared__ float4 smem_raw[];
  const int C = 2 * D + AL;
  const Bwd2 m = carve_bwd2(reinterpret_cast<float*>(smem_raw), W, D, C, H1);
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  float* xrow = m.X + t * m.XP;
  float* grow = m.G + t * m.DP;
  const float* adj = adjT + row0 * W;
  stage_dense2(w0, C, b0, 1, w1, b1, D, C, H1, m.w0, m.b0, m.w1T, m.b1);
  float gs[MAXF], xs[MAXF], xa[MAXF], xf[MAXF], dh1[MAXF], dxs[MAXF], dxa[MAXF], dxf[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) gs[d] = 0.0f;

  for (int k = K - 1; k >= 0; --k) {
    const size_t kb = (size_t)k * B + b;
    const float* s_in = k > 0 ? traj + ((size_t)(k - 1) * B + b) * W * D : s0 + row0 * D;
    stage_in(s_in, W, D, m.X, m.XP, 0);
    stage_in(agg + kb * W * D, W, D, m.X, m.XP, D);
    stage_in(fd + kb * W * AL, W, AL, m.X, m.XP, 2 * D);
    stage_in(g_traj + kb * W * D, W, D, m.G, m.DP, 0);
    __syncthreads();
    const uint8_t* ks = mode != kNoDrop ? ms + (kb * W + t) * D : nullptr;
    const uint8_t* ka = mode != kNoDrop ? ma + (kb * W + t) * D : nullptr;
    // x3 as K12 formed it, into registers and back into this node's X row
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      xs[d] = xa[d] = 0.0f;
      if (d < D) {
        xs[d] = drop(mode, da, db, xrow[d], ks != nullptr && ks[d] != 0);
        xa[d] = drop(mode, da, db, xrow[D + d], ka != nullptr && ka[d] != 0);
        xrow[d] = xs[d];
        xrow[D + d] = xa[d];
      }
      xf[d] = d < AL ? xrow[2 * D + d] : 0.0f;
    }
    // h1 recomputed, then dh1 = (g_traj[k] + gs) * act1'(h1) into G
    dense2_h1<MAXF>(m.w0, m.b0, m.w1T, m.b1, D, AL, H1, act0, xs, xa, xf, dh1);
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      dh1[d] = d < D ? (grow[d] + gs[d]) * act_grad(act1, dh1[d]) : 0.0f;
      if (d < D) grow[d] = dh1[d];
    }
    __syncthreads();  // G holds every node's dh1, X every node's x3
    bwd2_hidden<MAXF>(m, W, D, AL, H1, act0, xs, xa, xf, dh1, dxs, dxa, dxf,
                      dw0_out + (size_t)b * H1 * C, C, db0_out + (size_t)b * H1, 1,
                      dw1_out + (size_t)b * D * H1, db1_out + (size_t)b * D, k == K - 1);

    // dfd[k] = dx3[2D:]; dagg = dx3[D:2D] * a*ma into G; dx3[:D] * a*ms
    float* dfd_row = dfd + (kb * W + t) * AL;
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      if (d < AL) dfd_row[d] = dxf[d];
      if (d < D) {
        grow[d] = dxa[d] * drop_grad(mode, da, ka != nullptr && ka[d] != 0);
        dxs[d] *= drop_grad(mode, da, ks != nullptr && ks[d] != 0);
      }
    }
    __syncthreads();
    // gs[t] = dx3[:D] * a*ms + sum_dst adjT[t][dst] * dagg[dst] (the tiles are
    // free after the last chunk; contract_rows leaves X and G free for the next step)
    contract_rows<MAXF>(adj, W, m.G, m.DP, D, m.A, gs);
#pragma unroll
    for (int d = 0; d < MAXF; ++d) gs[d] += dxs[d];
  }
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    if (d < D) grow[d] = gs[d];
  __syncthreads();
  stage_out(gs_out + row0 * D, W, D, m.G, m.DP);
}

template <int MAXF>
cudaError_t launch_bwd2(const float* adjT, const float* s0, const float* traj, const float* agg,
                        const uint8_t* ms, const uint8_t* ma, const float* fd, const float* w0,
                        const float* b0, const float* w1, const float* b1, const float* g_traj,
                        float* gs, float* dw0, float* db0, float* dw1, float* db1, float* dfd,
                        int B, int W, int D, int AL, int H1, int K, int act0, int act1, int mode,
                        float da, float db, cudaStream_t stream) {
  const size_t bytes = bwd_smem(W, D, AL, H1);
  cudaError_t err = set_smem(train_loop2_bwd_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  train_loop2_bwd_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s0, traj, agg, ms, ma, fd, w0, b0,
                                                        w1, b1, g_traj, gs, dw0, db0, dw1, db1,
                                                        dfd, B, W, D, AL, H1, K, act0, act1, mode,
                                                        da, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// As gnn_train_loop2, plus traj, agg, g_traj [K, B, W, D] -> gs [B, W, D] and
// the per-block partials dw0 [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1],
// db1 [B, D], and dfd [K, B, W, AL]. Returns a cudaError_t code.
int gnn_train_loop2_bwd(const float* adjT, const float* s0, const float* traj, const float* agg,
                        const uint8_t* ms, const uint8_t* ma, const float* fd, const float* w0,
                        const float* b0, const float* w1, const float* b1, const float* g_traj,
                        float* gs, float* dw0, float* db0, float* dw1, float* db1, float* dfd,
                        int B, int W, int D, int AL, int H1, int K, int act0, int act1, int mode,
                        float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (mode != kNoDrop && (ms == nullptr || ma == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return launch_bwd2<16>(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, gs, dw0, db0,
                             dw1, db1, dfd, B, W, D, AL, H1, K, act0, act1, mode, da, db, st);
    case 32:
      return launch_bwd2<32>(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, gs, dw0, db0,
                             dw1, db1, dfd, B, W, D, AL, H1, K, act0, act1, mode, da, db, st);
    case 64:
      return launch_bwd2<64>(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, gs, dw0, db0,
                             dw1, db1, dfd, B, W, D, AL, H1, K, act0, act1, mode, da, db, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
