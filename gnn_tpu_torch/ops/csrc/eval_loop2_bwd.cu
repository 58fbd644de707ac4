// Reverse of the two-layer eval loop for Hopper (sm_90a), in plain fp32 on the
// CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K11 _loop2_bwd_kernel (launched by _loop2_bwd) -> gnn_propagation_loop2_bwd
//
// The K reverse iterations of K10 (fused2.cu) on one W-node block, which is
// how a two-layer state net without dropout and BatchNorm trains. K10 saves
// only the states, so reverse step k, from the state traj[k-1] (s0 for k = 0)
// and the loop-invariant arc-label aggregation f, first aggregates again:
//   agg = adjT^T @ s,  x3 = [s | agg | f],  h0 = w0 @ x3 + b0,
//   y0  = act0(h0),  h1 = w1 @ y0 + b1                      recomputed
//   g   = g_traj[k] + gs              -> daff += (g * act1(h1), g)   (affine only)
//   dh1 = g * scale * act1'(h1)       -> db1, dw1 += dh1 (x) y0
//   dh0 = (w1^T @ dh1) * act0'(h0)    -> db0, dw0 += dh0 (x) x3
//   dx3 = w0^T @ dh0                  -> dfeats += dx3[2D:]  (summed over k)
//   gs  = dx3[:D] + adjT @ dx3[D:2D]
// (scale, shift) is the optional inference-BatchNorm affine after act1.
//
// Design: K13 (train_loop2_bwd.cu) without dropout, with the aggregation
// recomputed and the affine's reductions; the hidden layer's reverse and its
// weight sums are the same device code (common.cuh::bwd2_hidden). One CTA per
// block, one thread per node (blockDim == W); shared memory holds the weights,
// every node's x3 row and its dh1 row, and two [W][kChunk] tiles. Each reverse
// step reads the adjacency twice: 32 rows at a time through the tiles for the
// aggregation (common.cuh::aggregate_slabs, a thread per destination reading
// a column) and 32 columns at a time for the dagg -> gs contraction
// (common.cuh::contract_rows, a thread per source reading a row); neither
// keeps the 66 KB adjacency resident, so a CTA takes 68.7 KB at W = 128,
// D = 14, AL = 3, H1 = 150. The weight partials and daff [2][D] leave per
// block, summed by torch in order (no atomics); dfeats is summed in registers
// over the K steps and written once.
//
// Bound: the function needs 2*H1*(9D + 3AL + 1) flops a node and reverse step
// (the forward recomputed once, the reverse dense layers, the weight-gradient
// sums), plus 4*D per arc, against about 8*D + 4*AL bytes a node and step
// (the states, the cotangents): the least time is set by the operations at
// the card's fp32 rate. This first version does 2*H1*(11D + 4AL + 1) (h0
// recomputed twice, as K13) and both adjacency passes densely (4*D*W*W flops
// a block and step).

#include "common.cuh"

namespace {

using namespace gnn;

// Floats of shared memory: K13's layout and the affine [2][D]
// (fused2.py::_smem_bytes mirrors it).
size_t loop2_bwd_smem(int W, int D, int AL, int H1) {
  return sizeof(float) * (bwd2_floats(W, D, 2 * D + AL, H1) + 2 * (size_t)D);
}

template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
loop2_bwd_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                 const float* __restrict__ traj, const float* __restrict__ feats,
                 const float* __restrict__ w0, const float* __restrict__ b0,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ aff, const float* __restrict__ g_traj,
                 float* __restrict__ gs_out, float* __restrict__ dw0_out,
                 float* __restrict__ db0_out, float* __restrict__ dw1_out,
                 float* __restrict__ db1_out, float* __restrict__ dfeats,
                 float* __restrict__ daff_out, int B, int W, int D, int AL, int H1, int K,
                 int act0, int act1) {
  extern __shared__ float4 smem_raw[];
  const int C = 2 * D + AL;
  const Bwd2 m = carve_bwd2(reinterpret_cast<float*>(smem_raw), W, D, C, H1);
  float* saff = m.rest;  // [2][D] scale; shift
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  float* xrow = m.X + t * m.XP;
  float* grow = m.G + t * m.DP;
  const float* adj = adjT + row0 * W;
  float* daff = daff_out + (size_t)b * 2 * D;  // this block's partial (with an affine)

  stage_dense2(w0, C, b0, 1, w1, b1, D, C, H1, m.w0, m.b0, m.w1T, m.b1);
  if (aff != nullptr)
    for (int i = t; i < 2 * D; i += blockDim.x) saff[i] = aff[i];
  stage_in(feats + row0 * AL, W, AL, m.X, m.XP, 2 * D);  // loop-invariant columns of x3
  __syncthreads();
  float gs[MAXF], xs[MAXF], xa[MAXF], xf[MAXF], dh1[MAXF], dxs[MAXF], dxa[MAXF], dxf[MAXF],
      dfacc[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    gs[d] = dfacc[d] = 0.0f;
    xf[d] = d < AL ? xrow[2 * D + d] : 0.0f;
  }

  for (int k = K - 1; k >= 0; --k) {
    const bool first = k == K - 1;  // the first reverse step writes the partials, later ones add
    const size_t kb = (size_t)k * B + b;
    const float* s_in = k > 0 ? traj + ((size_t)(k - 1) * B + b) * W * D : s0 + row0 * D;
    stage_in(s_in, W, D, m.X, m.XP, 0);
    stage_in(g_traj + kb * W * D, W, D, m.G, m.DP, 0);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < MAXF; ++d) xs[d] = d < D ? xrow[d] : 0.0f;
    // agg = adjT^T @ s, K10's aggregation again, into registers and this node's X row
    aggregate_slabs<MAXF>(adj, W, m.X, m.XP, D, m.A, xa);
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) xrow[D + d] = xa[d];
    dense2_h1<MAXF>(m.w0, m.b0, m.w1T, m.b1, D, AL, H1, act0, xs, xa, xf, dh1);  // h1
    // g = g_traj[k] + gs, the cotangent of this step's output state
#pragma unroll
    for (int d = 0; d < MAXF; ++d) gs[d] = d < D ? grow[d] + gs[d] : 0.0f;
    if (aff != nullptr) {
      // daff += sum over the block's nodes of (g * act1(h1), g), through G
#pragma unroll
      for (int d = 0; d < MAXF; ++d)
        if (d < D) grow[d] = gs[d] * activate(act1, dh1[d]);
      for (int part = 0; part < 2; ++part) {
        __syncthreads();
        for (int d = t; d < D; d += blockDim.x) {
          float acc = 0.0f;
          for (int n = 0; n < W; ++n) acc += m.G[n * m.DP + d];
          daff[part * D + d] = first ? acc : daff[part * D + d] + acc;
        }
        __syncthreads();
#pragma unroll
        for (int d = 0; d < MAXF; ++d)
          if (d < D) grow[d] = gs[d];
      }
#pragma unroll
      for (int d = 0; d < MAXF; ++d)
        if (d < D) gs[d] *= saff[d];
    }
    // dh1 = g * act1'(h1) into registers and G
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      dh1[d] = d < D ? gs[d] * act_grad(act1, dh1[d]) : 0.0f;
      if (d < D) grow[d] = dh1[d];
    }
    __syncthreads();  // G holds every node's dh1, X every node's x3
    bwd2_hidden<MAXF>(m, W, D, AL, H1, act0, xs, xa, xf, dh1, dxs, dxa, dxf,
                      dw0_out + (size_t)b * H1 * C, C, db0_out + (size_t)b * H1, 1,
                      dw1_out + (size_t)b * D * H1, db1_out + (size_t)b * D, first);
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      dfacc[d] += dxf[d];
      if (d < D) grow[d] = dxa[d];  // dagg
    }
    __syncthreads();
    // gs[t] = dx3[:D] + sum_dst adjT[t][dst] * dagg[dst]; contract_rows leaves
    // X and G free for the next step
    contract_rows<MAXF>(adj, W, m.G, m.DP, D, m.A, gs);
#pragma unroll
    for (int d = 0; d < MAXF; ++d) gs[d] += dxs[d];
  }
  float* df_row = dfeats + (row0 + t) * AL;
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < AL) df_row[d] = dfacc[d];
    if (d < D) grow[d] = gs[d];
  }
  __syncthreads();
  stage_out(gs_out + row0 * D, W, D, m.G, m.DP);
}

template <int MAXF>
cudaError_t launch(const float* adjT, const float* s0, const float* traj, const float* feats,
                   const float* w0, const float* b0, const float* w1, const float* b1,
                   const float* aff, const float* g_traj, float* gs, float* dw0, float* db0,
                   float* dw1, float* db1, float* dfeats, float* daff, int B, int W, int D, int AL,
                   int H1, int K, int act0, int act1, cudaStream_t stream) {
  const size_t bytes = loop2_bwd_smem(W, D, AL, H1);
  cudaError_t err = set_smem(loop2_bwd_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  loop2_bwd_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s0, traj, feats, w0, b0, w1, b1, aff,
                                                  g_traj, gs, dw0, db0, dw1, db1, dfeats, daff, B,
                                                  W, D, AL, H1, K, act0, act1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], traj [K, B, W, D] (K10's), feats [B, W, AL],
// w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D], aff [2, D] (null: none),
// g_traj [K, B, W, D] -> gs [B, W, D], the per-block partials dw0
// [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1], db1 [B, D] and daff [B, 2, D]
// (with aff), and dfeats [B, W, AL]. Returns a cudaError_t code.
int gnn_propagation_loop2_bwd(const float* adjT, const float* s0, const float* traj,
                              const float* feats, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* aff,
                              const float* g_traj, float* gs, float* dw0, float* db0, float* dw1,
                              float* db1, float* dfeats, float* daff, int B, int W, int D, int AL,
                              int H1, int K, int act0, int act1, void* stream) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if ((aff == nullptr) != (daff == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return launch<16>(adjT, s0, traj, feats, w0, b0, w1, b1, aff, g_traj, gs, dw0, db0, dw1, db1,
                        dfeats, daff, B, W, D, AL, H1, K, act0, act1, st);
    case 32:
      return launch<32>(adjT, s0, traj, feats, w0, b0, w1, b1, aff, g_traj, gs, dw0, db0, dw1, db1,
                        dfeats, daff, B, W, D, AL, H1, K, act0, act1, st);
    case 64:
      return launch<64>(adjT, s0, traj, feats, w0, b0, w1, b1, aff, g_traj, gs, dw0, db0, dw1, db1,
                        dfeats, daff, B, W, D, AL, H1, K, act0, act1, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
