// K1_bf16 and K2_bf16, the BatchNorm-training iteration of a one-layer state
// net and its reverse on a bf16 block adjacency, for Hopper (sm_90a):
// gnn_tpu's `hp = False` branch of _bn_fwd_kernel and _bn_bwd_kernel
// (pallas_bn.py:97-140, :203-260). One iteration on one W-node block row,
// x3 = [s | agg | feats] the dense input of C1 = 2D + F columns, w_aug =
// [Ws | Wa | Wf | b] [D, C1 + 1], bf as in bf16.cuh:
//   s     = y1 * scale1 + shift1,  s_old = y2 * scale2 + shift2
//   marg  = nm if ||s - s_old|| > thr * ||s_old|| else 0
//   agg   = adjT^T @ bf(s) (+ rT)          over the sources ascending
//   h     = bf([drop(x3) | 1]) @ bf(w_aug)^T   the bias column through bf16
//   y     = act(h),  msum = sum over the block's nodes of y * nm
// and the reverse, from the BatchNorm coefficients bnv [9, D]
// (ops/bn.py::BNV_ROWS):
//   gy    = gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2)
//   dh    = gy * act'(h)                    h recomputed as the forward's
//   dw    = dh^T @ [drop(x3) | 1]           f32 operands (gnn_tpu's _BDT_HI)
//   dx2   = bf(dh) @ bf(w_aug[:, :2D])
//   dagg  = dx2_agg * dm,  ds = dx2_s * dm + adjT @ bf(dagg)  over the destinations
//   red   = (sum ds, sum ds * x_hat_prev)   per block row
// Every sum runs over its index ascending, one f32 add a term (products of
// bf values are exact, so fmaf adds them once rounded), the elementwise
// steps multiply then add as the plain versions do (__fmul_rn, __fadd_rn),
// and the activation and its derivative go through act64 / act_grad64:
// a launch gives the plain versions' bits (ops/bn.py::
// bn_{forward,backward}_step_bf16_ref), dw and the block sums included.
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K1 _bn_fwd_kernel with a bf16 adjacency (hp false, launched by
//      _bn_fwd_call) -> gnn_bn_forward_bf16
//   K2 _bn_bwd_kernel with a bf16 adjacency (hp false, launched by
//      _bn_bwd_call) -> gnn_bn_backward_bf16
// The f32 K1 is in bn_fwd.cu, K2 in bn_train.cu. Row r < Bl reads
// adj_loop[r], the rest adj_dep[r - Bl], where they lie.
//
// Design (bf16.cuh's, simple, not yet tuned): one CTA of 256 threads a block
// row, the bf16 adjacency staged in shared memory (2*W*W bytes, 32 KiB at
// W = 128) beside x3 [W][C1] and three rows [W][D] (K1: s, y; K2: dh, ds
// and bf(dagg)); the weights read through the read-only cache. The
// aggregations run over the dense staged adjacency. No atomics: a repeat
// launch is bit-identical.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block row), the f32
// rows, keep bytes and outputs once; the operations 2*D an arc (K2: twice
// that) and 2*D*(C1 + 1) a node (K2: the dense layer, dw and dx2) at the
// dense bf16 tensor-core rate (chip_smoke.py::bf16_bounds). The CUDA-core
// FMAs over the dense adjacency run far from it; tensor-core tiles are a
// later redesign's.

#include "bf16.cuh"

namespace {

using namespace gnn;

// The shared-memory regions: the adjacency [W][W], x3 [W][C1], rows r0, r1,
// r2 [W][D] (bn_bf16_smem; ops/bn.py::bn_bf16_smem_bytes).
struct BnBf16Smem {
  uint16_t* adj;
  float* x3;
  float* r0;
  float* r1;
  float* r2;
};

inline size_t bn_bf16_smem(int W, int D, int F) {
  return 2 * (size_t)W * W + 4 * (size_t)W * (2 * D + F + 3 * D);
}

__device__ BnBf16Smem bn_bf16_layout(void* base, int W, int D, int C1) {
  BnBf16Smem m;
  m.adj = static_cast<uint16_t*>(base);
  m.x3 = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  m.r0 = m.x3 + W * C1;
  m.r1 = m.r0 + W * D;
  m.r2 = m.r1 + W * D;
  return m;
}

__global__ void __launch_bounds__(kBf16Threads)
bn_fwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                   const float* __restrict__ y1, const float* __restrict__ y2,
                   const float* __restrict__ aff, const uint8_t* __restrict__ keep,
                   const float* __restrict__ rT, const float* __restrict__ feats,
                   const float* __restrict__ w_aug, const float* __restrict__ nm,
                   float* __restrict__ y_out, float* __restrict__ agg_out,
                   float* __restrict__ marg, float* __restrict__ msum, int Bl, int W, int D,
                   int F, float thr, int act, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, WD = W * D;
  const BnBf16Smem m = bn_bf16_layout(smem_f4, W, D, C1);
  const size_t row = (size_t)blockIdx.x * W;
  float* s = m.r0;
  float* y = m.r1;
  bn_stage_adj(m.adj, adj_loop, adj_dep, Bl, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const float v = __fadd_rn(__fmul_rn(__ldg(y1 + row * D + i), __ldg(aff + d)),
                              __ldg(aff + D + d));
    s[i] = v;
    m.x3[n * C1 + d] = drop_rn(mode, da, db, v, keep, (row + n) * C1 + d);
  }
  bn_stage_feats(m.x3, feats, keep, W, D, F, mode, da, db);
  __syncthreads();
  bn_margins(s, [&](int n, int d) {
    return __fadd_rn(__fmul_rn(__ldg(y2 + (row + n) * D + d), __ldg(aff + 2 * D + d)),
                     __ldg(aff + 3 * D + d));
  }, nm, marg, W, D, thr);
  bn_aggregate(m.adj, s, m.x3, rT, agg_out, keep, W, D, C1, mode, da, db);
  __syncthreads();
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, o = i % D;
    const float v = act64(act, bn_dense_row(m.x3 + n * C1, w_aug + (size_t)o * (C1 + 1), C1));
    y[i] = v;
    y_out[row * D + i] = v;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int n = 0; n < W; ++n)
      acc = __fadd_rn(acc, __fmul_rn(y[n * D + d], __ldg(nm + row + n)));
    msum[(size_t)blockIdx.x * D + d] = acc;
  }
}

__global__ void __launch_bounds__(kBf16Threads)
bn_bwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                   const float* __restrict__ y_prev, const float* __restrict__ y_k,
                   const float* __restrict__ agg, const uint8_t* __restrict__ keep,
                   const float* __restrict__ feats, const float* __restrict__ w_aug,
                   const float* __restrict__ ds_in, const float* __restrict__ gsel,
                   const float* __restrict__ bnv, const float* __restrict__ flag,
                   const float* __restrict__ nm, float* __restrict__ ds_out,
                   float* __restrict__ dw, float* __restrict__ dagg_out, float* __restrict__ red,
                   int Bl, int W, int D, int F, int act, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, C = C1 + 1, WD = W * D;
  const BnBf16Smem m = bn_bf16_layout(smem_f4, W, D, C1);
  const size_t row = (size_t)blockIdx.x * W;
  float* dh = m.r0;   // gy, then dh
  float* ds = m.r1;   // dx2's state slice, then ds
  float* dg = m.r2;   // bf(dagg)
  const float f = *flag;
  bn_stage_adj(m.adj, adj_loop, adj_dep, Bl, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const size_t g = row * D + i;
    const float sp = __fadd_rn(__fmul_rn(__ldg(y_prev + g), __ldg(bnv + d)), __ldg(bnv + D + d));
    m.x3[n * C1 + d] = drop_rn(mode, da, db, sp, keep, (row + n) * C1 + d);
    m.x3[n * C1 + D + d] = drop_rn(mode, da, db, __ldg(agg + g), keep, (row + n) * C1 + D + d);
    dh[i] = bn_gy(bnv, __ldg(ds_in + g), __ldg(gsel + g), __ldg(y_k + g), f,
                  __ldg(nm + row + n), D, d);
  }
  bn_stage_feats(m.x3, feats, keep, W, D, F, mode, da, db);
  __syncthreads();
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, o = i % D;
    dh[i] = __fmul_rn(dh[i], act_grad64(act, bn_dense_row(m.x3 + n * C1,
                                                          w_aug + (size_t)o * C, C1)));
  }
  __syncthreads();
  // dw = dh^T @ [x3 | 1], the nodes ascending (per-block partials)
  float* dw_r = dw + (size_t)blockIdx.x * D * C;
  for (int i = threadIdx.x; i < D * C; i += blockDim.x) {
    const int o = i / C, c = i % C;
    float acc = 0.0f;
    for (int n = 0; n < W; ++n)
      acc = __fadd_rn(acc, c < C1 ? __fmul_rn(dh[n * D + o], m.x3[n * C1 + c]) : dh[n * D + o]);
    dw_r[i] = acc;
  }
  // dx2 = bf(dh) @ bf(w_aug[:, :2D]), the outputs ascending, through dm
  for (int i = threadIdx.x; i < 2 * WD; i += blockDim.x) {
    const int n = i / (2 * D), c = i % (2 * D);
    float acc = 0.0f;
    for (int o = 0; o < D; ++o)
      acc = fmaf(bf(dh[n * D + o]), bf(__ldg(w_aug + (size_t)o * C + c)), acc);
    bn_split_dx2(acc, n, c, ds, dg, dagg_out, keep, W, D, C1, mode, da);
  }
  __syncthreads();
  bn_contract(m.adj, dg, ds, ds_out, W, D);  // ds = dx2_s + adjT @ bf(dagg)
  __syncthreads();
  bn_reductions(ds, y_prev, bnv, red, W, D);
}

}  // namespace

extern "C" {

// adj_loop bf16 [Bl, W, W] and adj_dep bf16 [R - Bl, W, W] (either null
// without rows), y1, y2 [R, W, D], aff [2, 2, D], keep uint8 [R, W, 2D + F]
// (null without dropout), rT [R, W, D] (nullable), feats [R, W, F], w_aug
// [D, 2D + F + 1], nm [R, W] -> y, agg [R, W, D], marg [R, W], msum [R, D].
// Returns a cudaError_t code.
int gnn_bn_forward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep, const float* y1,
                        const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                        const float* feats, const float* w_aug, const float* nm, float* y,
                        float* agg, float* marg, float* msum, int R, int Bl, int W, int D, int F,
                        float thr, int act, int mode, float da, float db, void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = bn_bf16_smem(W, D, F);
  cudaError_t err = set_smem(bn_fwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bn_fwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, y, agg, marg, msum, Bl, W, D,
      F, thr, act, mode, da, db);
  return cudaGetLastError();
}

// As gnn_bn_forward_bf16's, y_prev, y_k, agg, ds_in, gsel [R, W, D], bnv
// [9, D], flag a device float (0 or 1) -> ds, dagg [R, W, D], dw
// [R, D, 2D + F + 1], red [R, 2, D] (per block row). Returns a cudaError_t
// code.
int gnn_bn_backward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep, const float* y_prev,
                         const float* y_k, const float* agg, const uint8_t* keep,
                         const float* feats, const float* w_aug, const float* ds_in,
                         const float* gsel, const float* bnv, const float* flag, const float* nm,
                         float* ds, float* dw, float* dagg, float* red, int R, int Bl, int W,
                         int D, int F, int act, int mode, float da, float db, void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = bn_bf16_smem(W, D, F);
  cudaError_t err = set_smem(bn_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bn_bwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel, bnv, flag, nm, ds, dw,
      dagg, red, Bl, W, D, F, act, mode, da, db);
  return cudaGetLastError();
}

}  // extern "C"
