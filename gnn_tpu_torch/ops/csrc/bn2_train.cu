// BatchNorm-training propagation kernels of a two-layer state net for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16): the
// reference's default state net (trailing BatchNorm, input dropout) with a
// hidden layer of width H1.
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K14 _bn2_fwd_kernel (launched by _bn2_fwd_call) -> gnn_bn2_forward
//   K15 _bn2_bwd_kernel (launched by _bn2_bwd_call) -> gnn_bn2_backward
//
// As K1/K2 (bn_train.cu), one launch runs one iteration over every block row,
// since the BatchNorm couples every block through the batch moments, and
// [D]-sized glue (ops/bn.py) runs between launches. C = 2D + F is the width
// of the dense input x3 = [s | agg | feats]; w0_aug = [Ws | Wa | Wf | b0]
// [H1, C + 1], w1 [D, H1], b1 [D].
// K14, one iteration on one W-node block:
//   s     = y1 * scale1 + shift1,  s_old = y2 * scale2 + shift2
//   marg  = nm if ||s - s_old|| > thr * ||s_old|| else 0
//   agg   = adjT^T @ s (+ rT)                  written before the dropout
//   y     = act1(w1 @ act0(w0_aug @ [drop(x3); 1]) + b1)   the pre-BN activation
//   msum  = sum over the block's nodes of y * nm
// K15, its reverse with the BatchNorm backward folded in from the [9, D]
// coefficient rows bnv (ops/bn.py::BNV_ROWS), h0 and h1 recomputed:
//   gy    = gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2)
//   dh1   = gy * act1'(h1)                     -> db1, dw1 (per-block partials)
//   dh0   = (w1^T @ dh1) * act0'(h0)           -> dw0 = dh0^T @ [drop(x3); 1]
//   dagg  = (dh0 @ Wa) * dmask,  ds = (dh0 @ Ws) * dmask + adjT @ dagg
//   red   = (sum ds, sum ds * x_hat_prev)      (per-block partial)
//
// Design: one CTA per block, one thread per node (blockDim == W); row r < Bl
// reads adj_loop[r], the rest adj_dep[r - Bl], where they lie. K14 is K1 with
// the hidden layer through common.cuh::dense2_h1 (a thread loops over the H1
// hidden units: no H1-wide row is stored), and it aggregates through 32-row
// slabs of the adjacency (common.cuh::aggregate_slabs) rather than holding
// the 66 KB adjacency: 64.3 KB a CTA at W = 128, D = 14, F = 3, H1 = 150. K15
// is K2 with K13's chunked hidden-layer reverse and weight sums
// (common.cuh::bwd2_hidden) and the row contraction through 32-column slabs
// (common.cuh::contract_rows): 68.8 KB a CTA. Partials over nodes leave per
// block, each entry owned by one thread (no atomics: a result does not vary
// between runs). Keep bits are read from device memory by each node's thread.
//
// Bound: the hidden layer sets it: 2*H1*(3D + F + 1) flops a node forward and
// 2*H1*(9D + 2F + 1) backward (the forward again, the bias-augmented weight
// sums, dx3's state and aggregation columns: no feats cotangent), against
// about 6*D + F + 2D + F bytes a node
// read and written: the least time is set by the operations at the card's
// fp32 rate. This first version contracts the adjacency densely (2*D*W*W
// flops a block), and K15 recomputes h0 twice (as K13).

#include "common.cuh"

namespace {

using namespace gnn;

// Floats of shared memory (ops/bn.py::_smem2_bytes mirrors both).
// K14: x3 rows, a row staging buffer, a [32][W + 1] adjacency slab, the
// weights, the two affines [4][D] and the node mask [W].
size_t fwd2_smem(int W, int D, int F, int H1) {
  const int C = 2 * D + F;
  return sizeof(float) * ((size_t)W * (C | 1) + (size_t)W * (D | 1) + 32 * (size_t)(W + 1) +
                          (size_t)H1 * (C + D + 1) + (size_t)D + 4 * (size_t)D + (size_t)W);
}

// K15: the two-layer reverse layout (common.cuh::carve_bwd2), bnv [9][D] and
// the node mask [W].
size_t bwd2_smem(int W, int D, int F, int H1) {
  return sizeof(float) * (bwd2_floats(W, D, 2 * D + F, H1) + 9 * (size_t)D + (size_t)W);
}

// K14: one two-layer BN-training iteration over every block row.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
bn2_fwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y1, const float* __restrict__ y2,
               const float* __restrict__ aff, const uint8_t* __restrict__ keep,
               const float* __restrict__ rT, const float* __restrict__ feats,
               const float* __restrict__ w0_aug, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ nm, float* __restrict__ y,
               float* __restrict__ agg, float* __restrict__ marg, float* __restrict__ msum,
               int Bl, int W, int D, int F, int H1, float thr, int act0, int act1, int mode,
               float da, float db) {
  extern __shared__ float4 smem_raw[];
  const int C = 2 * D + F, XP = C | 1, DP = D | 1;
  float* X = reinterpret_cast<float*>(smem_raw);  // [W][XP] x3 rows
  float* rows = X + W * XP;                       // [W][DP] staging
  float* A = rows + W * DP;                       // [32][W + 1] adjacency slab
  float* sw0 = A + 32 * (W + 1);                  // [H1][C]
  float* sb0 = sw0 + H1 * C;                      // [H1]
  float* sw1T = sb0 + H1;                         // [H1][D]
  float* sb1 = sw1T + H1 * D;                     // [D]
  float* vec = sb1 + D;                           // [4][D] scale1; shift1; scale2; shift2
  float* nms = vec + 4 * D;                       // [W]
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  float* xrow = X + t * XP;
  float* rrow = rows + t * DP;

  stage_dense2(w0_aug, C + 1, w0_aug + C, C + 1, w1, b1, D, C, H1, sw0, sb0, sw1T, sb1);
  for (int i = t; i < 4 * D; i += blockDim.x) vec[i] = aff[i];
  nms[t] = nm[row0 + t];
  stage_in(feats + row0 * F, W, F, X, XP, 2 * D);
  stage_in(y1 + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  // s -> x3 columns [0, D); rounded as the plain version's multiply, then add
  for (int d = 0; d < D; ++d) xrow[d] = __fadd_rn(__fmul_rn(rrow[d], vec[d]), vec[D + d]);
  __syncthreads();
  stage_in(y2 + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  float dist2 = 0.0f, norm2 = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float so = __fadd_rn(__fmul_rn(rrow[d], vec[2 * D + d]), vec[3 * D + d]);
    const float diff = __fsub_rn(xrow[d], so);
    dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
    norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
  }
  marg[row0 + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[t] : 0.0f;
  __syncthreads();
  if (rT != nullptr) stage_in(rT + row0 * D, W, D, rows, DP, 0);
  // (aggregate_slabs synchronises before it reads any row)

  // agg[t] = sum_src adjT[src][t] * s[src] (+ rT), before the dropout
  float xs[MAXF], xa[MAXF], xf[MAXF], h1[MAXF];
  aggregate_slabs<MAXF>(block_adj(adj_loop, adj_dep, Bl, W), W, X, XP, D, A, xa);
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      if (rT != nullptr) xa[d] += rrow[d];
      rrow[d] = xa[d];
      xrow[D + d] = xa[d];
    }
  }
  if (keep != nullptr) drop_row(xrow, keep + (row0 + t) * C, C, mode, da, db);
  __syncthreads();
  stage_out(agg + row0 * D, W, D, rows, DP);
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    xs[d] = d < D ? xrow[d] : 0.0f;
    xa[d] = d < D ? xrow[D + d] : 0.0f;
    xf[d] = d < F ? xrow[2 * D + d] : 0.0f;
  }
  dense2_h1<MAXF>(sw0, sb0, sw1T, sb1, D, F, H1, act0, xs, xa, xf, h1);
  __syncthreads();  // agg is out of rows
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    if (d < D) rrow[d] = activate(act1, h1[d]);
  __syncthreads();
  stage_out(y + row0 * D, W, D, rows, DP);
  for (int d = t; d < D; d += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < W; ++n) s = fmaf(rows[n * DP + d], nms[n], s);
    msum[(size_t)r * D + d] = s;
  }
}

// K15: one reverse two-layer BN-training iteration over every block row.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
bn2_bwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y_prev, const float* __restrict__ y_k,
               const float* __restrict__ agg, const uint8_t* __restrict__ keep,
               const float* __restrict__ feats, const float* __restrict__ w0_aug,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ ds_in, const float* __restrict__ gsel,
               const float* __restrict__ bnv, const float* __restrict__ flag,
               const float* __restrict__ nm, float* __restrict__ ds, float* __restrict__ dw0,
               float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dagg,
               float* __restrict__ red, int Bl, int W, int D, int F, int H1, int act0, int act1,
               int mode, float da, float db) {
  extern __shared__ float4 smem_raw[];
  const int C = 2 * D + F;
  const Bwd2 m = carve_bwd2(reinterpret_cast<float*>(smem_raw), W, D, C, H1);
  float* v = m.rest;      // [9][D] bnv rows, ops/bn.py::BNV_ROWS
  float* nms = v + 9 * D;  // [W]
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  float* xrow = m.X + t * m.XP;
  float* grow = m.G + t * m.DP;
  const uint8_t* krow = mode != kNoDrop ? keep + (row0 + t) * C : nullptr;

  stage_dense2(w0_aug, C + 1, w0_aug + C, C + 1, w1, b1, D, C, H1, m.w0, m.b0, m.w1T, m.b1);
  for (int i = t; i < 9 * D; i += blockDim.x) v[i] = bnv[i];
  nms[t] = nm[row0 + t];
  stage_in(y_prev + row0 * D, W, D, m.X, m.XP, 0);
  stage_in(agg + row0 * D, W, D, m.X, m.XP, D);
  stage_in(feats + row0 * F, W, F, m.X, m.XP, 2 * D);
  stage_in(ds_in + row0 * D, W, D, m.G, m.DP, 0);
  __syncthreads();
  // the forward's dropped x3 row: s_prev (rounded as the plain version), agg, feats
  for (int d = 0; d < D; ++d) xrow[d] = __fadd_rn(__fmul_rn(xrow[d], v[d]), v[D + d]);
  drop_row(xrow, krow, C, mode, da, db);
  float xs[MAXF], xa[MAXF], xf[MAXF], g[MAXF], h1[MAXF], dxs[MAXF], dxa[MAXF], dxf[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    xs[d] = d < D ? xrow[d] : 0.0f;
    xa[d] = d < D ? xrow[D + d] : 0.0f;
    xf[d] = d < F ? xrow[2 * D + d] : 0.0f;
    g[d] = d < D ? grow[d] : 0.0f;
  }
  // gy from the state cotangent and the BatchNorm backward coefficients
  __syncthreads();
  stage_in(gsel + row0 * D, W, D, m.G, m.DP, 0);
  __syncthreads();
  const float f = *flag;
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    if (d < D) g[d] += f * grow[d];
  __syncthreads();
  stage_in(y_k + row0 * D, W, D, m.G, m.DP, 0);
  __syncthreads();
  const float nmv = nms[t];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      const float xk = (grow[d] - v[2 * D + d]) * v[3 * D + d];
      g[d] = v[4 * D + d] * g[d] - nmv * (v[5 * D + d] + xk * v[6 * D + d]);
    }
  }
  // h1 recomputed, dh1 = gy * act1'(h1) into registers and G (own row only)
  dense2_h1<MAXF>(m.w0, m.b0, m.w1T, m.b1, D, F, H1, act0, xs, xa, xf, h1);
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    g[d] = d < D ? g[d] * act_grad(act1, h1[d]) : 0.0f;
    if (d < D) grow[d] = g[d];
  }
  __syncthreads();  // G holds every node's dh1, X every node's x3
  float* dw0_r = dw0 + (size_t)r * H1 * (C + 1);  // bias-augmented: db0 is its last column
  bwd2_hidden<MAXF>(m, W, D, F, H1, act0, xs, xa, xf, g, dxs, dxa, dxf, dw0_r, C + 1, dw0_r + C,
                    C + 1, dw1 + (size_t)r * D * H1, db1 + (size_t)r * D, true);

  // dx = dh0 @ [Ws | Wa], through the dropout's derivative a * keep
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      dxs[d] *= drop_grad(mode, da, krow != nullptr && krow[d] != 0);
      dxa[d] *= drop_grad(mode, da, krow != nullptr && krow[D + d] != 0);
      grow[d] = dxa[d];
    }
  }
  __syncthreads();
  stage_out(dagg + row0 * D, W, D, m.G, m.DP);
  // ds[t] = dxs[t] + sum_dst adjT[t][dst] * dagg[dst], row t of the adjacency
  contract_rows<MAXF>(block_adj(adj_loop, adj_dep, Bl, W), W, m.G, m.DP, D, m.A, dxa);
  // ds into G, ds * x_hat_prev into X (both free after contract_rows)
  const float* yp = y_prev + (row0 + t) * D;
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      const float dsv = dxs[d] + dxa[d];
      grow[d] = dsv;
      xrow[d] = dsv * ((yp[d] - v[7 * D + d]) * v[8 * D + d]);
    }
  }
  __syncthreads();
  stage_out(ds + row0 * D, W, D, m.G, m.DP);
  // the next reverse step's reduction partials
  for (int d = t; d < D; d += blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int n = 0; n < W; ++n) {
      s0 += m.G[n * m.DP + d];
      s1 += m.X[n * m.XP + d];
    }
    red[(size_t)r * 2 * D + d] = s0;
    red[(size_t)r * 2 * D + D + d] = s1;
  }
}

bool shape_ok(int R, int Bl, int W, int D, int F, int H1) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && H1 > 0 && width_class(D > F ? D : F) != 0;
}

template <int MAXF>
cudaError_t launch_fwd(const float* adj_loop, const float* adj_dep, const float* y1,
                       const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                       const float* feats, const float* w0_aug, const float* w1, const float* b1,
                       const float* nm, float* y, float* agg, float* marg, float* msum, int R,
                       int Bl, int W, int D, int F, int H1, float thr, int act0, int act1,
                       int mode, float da, float db, cudaStream_t stream) {
  const size_t bytes = fwd2_smem(W, D, F, H1);
  cudaError_t err = set_smem(bn2_fwd_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  bn2_fwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats,
                                                 w0_aug, w1, b1, nm, y, agg, marg, msum, Bl, W, D,
                                                 F, H1, thr, act0, act1, mode, da, db);
  return cudaGetLastError();
}

template <int MAXF>
cudaError_t launch_bwd(const float* adj_loop, const float* adj_dep, const float* y_prev,
                       const float* y_k, const float* agg, const uint8_t* keep,
                       const float* feats, const float* w0_aug, const float* w1, const float* b1,
                       const float* ds_in, const float* gsel, const float* bnv, const float* flag,
                       const float* nm, float* ds, float* dw0, float* dw1, float* db1, float* dagg,
                       float* red, int R, int Bl, int W, int D, int F, int H1, int act0, int act1,
                       int mode, float da, float db, cudaStream_t stream) {
  const size_t bytes = bwd2_smem(W, D, F, H1);
  cudaError_t err = set_smem(bn2_bwd_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  bn2_bwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats,
                                                 w0_aug, w1, b1, ds_in, gsel, bnv, flag, nm, ds,
                                                 dw0, dw1, db1, dagg, red, Bl, W, D, F, H1, act0,
                                                 act1, mode, da, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// adj_loop [Bl, W, W], adj_dep [R - Bl, W, W] (null when Bl == R); y1, y2,
// rT (nullable) [R, W, D]; aff [2, 2, D]; keep uint8 [R, W, 2D + F] (null
// when mode == 0); feats [R, W, F]; w0_aug [H1, 2D + F + 1]; w1 [D, H1];
// b1 [D]; nm [R, W] -> y, agg [R, W, D], marg [R, W], msum [R, D]. Returns a
// cudaError_t code.
int gnn_bn2_forward(const float* adj_loop, const float* adj_dep, const float* y1,
                    const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                    const float* feats, const float* w0_aug, const float* w1, const float* b1,
                    const float* nm, float* y, float* agg, float* marg, float* msum, int R,
                    int Bl, int W, int D, int F, int H1, float thr, int act0, int act1, int mode,
                    float da, float db, void* stream) {
  if (!shape_ok(R, Bl, W, D, F, H1)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > F ? D : F)) {
    case 16:
      return launch_fwd<16>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm, y,
                            agg, marg, msum, R, Bl, W, D, F, H1, thr, act0, act1, mode, da, db,
                            st);
    case 32:
      return launch_fwd<32>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm, y,
                            agg, marg, msum, R, Bl, W, D, F, H1, thr, act0, act1, mode, da, db,
                            st);
    default:
      return launch_fwd<64>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm, y,
                            agg, marg, msum, R, Bl, W, D, F, H1, thr, act0, act1, mode, da, db,
                            st);
  }
}

// As gnn_bn2_forward, plus y_prev, y_k, agg, ds_in, gsel [R, W, D]; bnv [9, D];
// flag a device float (0 or 1) -> ds, dagg [R, W, D] and the per-block
// partials dw0 [R, H1, 2D + F + 1], dw1 [R, D, H1], db1 [R, D], red [R, 2, D].
// Returns a cudaError_t code.
int gnn_bn2_backward(const float* adj_loop, const float* adj_dep, const float* y_prev,
                     const float* y_k, const float* agg, const uint8_t* keep, const float* feats,
                     const float* w0_aug, const float* w1, const float* b1, const float* ds_in,
                     const float* gsel, const float* bnv, const float* flag, const float* nm,
                     float* ds, float* dw0, float* dw1, float* db1, float* dagg, float* red, int R,
                     int Bl, int W, int D, int F, int H1, int act0, int act1, int mode, float da,
                     float db, void* stream) {
  if (!shape_ok(R, Bl, W, D, F, H1)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > F ? D : F)) {
    case 16:
      return launch_bwd<16>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1,
                            ds_in, gsel, bnv, flag, nm, ds, dw0, dw1, db1, dagg, red, R, Bl, W, D,
                            F, H1, act0, act1, mode, da, db, st);
    case 32:
      return launch_bwd<32>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1,
                            ds_in, gsel, bnv, flag, nm, ds, dw0, dw1, db1, dagg, red, R, Bl, W, D,
                            F, H1, act0, act1, mode, da, db, st);
    default:
      return launch_bwd<64>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1,
                            ds_in, gsel, bnv, flag, nm, ds, dw0, dw1, db1, dagg, red, R, Bl, W, D,
                            F, H1, act0, act1, mode, da, db, st);
  }
}

}  // extern "C"
