// K14_bf16 and K15_bf16, the BatchNorm-training iteration of a two-layer
// state net and its reverse on a bf16 block adjacency, for Hopper (sm_90a):
// gnn_tpu's `hp = False` branch of _bn2_fwd_kernel and _bn2_bwd_kernel
// (pallas_bn.py:568-612, :677-738). One iteration on one W-node block row,
// x3 = [s | agg | feats] the dense input of C1 = 2D + F columns, w0_aug =
// [Ws | Wa | Wf | b0] [H1, C1 + 1], w1 [D, H1], b1 [D], bf as in bf16.cuh:
//   s     = y1 * scale1 + shift1,  s_old = y2 * scale2 + shift2
//   marg  = nm if ||s - s_old|| > thr * ||s_old|| else 0
//   agg   = adjT^T @ bf(s) (+ rT)            over the sources ascending
//   h0    = bf([drop(x3) | 1]) @ bf(w0_aug)^T   the bias column through bf16
//   h1    = bf(act0(h0)) @ bf(w1)^T + b1,  y = act1(h1)
//   msum  = sum over the block's nodes of y * nm
// and the reverse, from the BatchNorm coefficients bnv [9, D]
// (ops/bn.py::BNV_ROWS), h0, y0 and h1 recomputed as the forward's:
//   gy    = gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2)
//   dh1   = gy * act1'(h1);  db1 = sum dh1;  dw1 = dh1^T @ y0
//   dh0   = (bf(dh1) @ bf(w1)) * act0'(h0);  dw0 = dh0^T @ [drop(x3) | 1]
//   dx2   = bf(dh0) @ bf(w0_aug[:, :2D])
//   dagg  = dx2_agg * dm,  ds = dx2_s * dm + adjT @ bf(dagg)  over the destinations
//   red   = (sum ds, sum ds * x_hat_prev)
// y0 and x3 enter dw1 and dw0 unrounded (gnn_tpu's _BDT_HI). Every sum runs
// over its index ascending, one f32 add a term (products of bf values are
// exact, so fmaf adds them once rounded), dw0, dw1, db1, msum and red node
// by node with each product rounded, the elementwise steps as the plain
// versions take them (__fmul_rn, __fadd_rn), the activations through
// act64 / act_grad64: a launch gives the plain versions' bits
// (ops/bn.py::bn2_{forward,backward}_step_bf16_ref), the per-block
// partials included.
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K14 _bn2_fwd_kernel with a bf16 adjacency (hp false, launched by
//       _bn2_fwd_call) -> gnn_bn2_forward_bf16
//   K15 _bn2_bwd_kernel with a bf16 adjacency (hp false, launched by
//       _bn2_bwd_call) -> gnn_bn2_backward_bf16
// The f32 K14 is in bn2_fwd.cu, K15 in bn2_train.cu. Row r < Bl reads
// adj_loop[r], the rest adj_dep[r - Bl], where they lie.
//
// Design (bn_bf16.cu's CTA with K12_bf16's hidden chunks; simple, not yet
// tuned): one CTA of 256 threads a block row, the bf16 adjacency staged in
// shared memory (2*W*W bytes, 32 KiB at W = 128) beside x3 [W][C1], the rows
// [W][D] and hidden chunks [W][kBf16Chunk]; the first layer is K1_bf16's,
// H1 units wide in chunks of 32. The forward takes a chunk's bf(y0), then
// its terms of h1. The reverse runs the chunks twice: for h1 (its terms need
// every chunk), then for h0, y0, dh0 and the chunk's dw1 and dw0 columns and
// terms of dx2 [W][2D]. The weights are read through the read-only cache.
// The partials are each block row's own slices of the outputs. No atomics:
// a repeat launch is bit-identical.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block row), the f32
// rows, keep bytes and outputs once; the operations 2*D an arc and
// 2*(H1*C + D*H1) a node (K15: the forward's dense layers, dy0, dx2 and ds's
// 2*D an arc in bf16, dw1 and dw0 in fp32) at the dense bf16 tensor-core
// rate (chip_smoke.py::bf16_bounds). The CUDA-core FMAs over the dense
// staged adjacency run far from it; tensor-core tiles are a later
// redesign's.

#include "bf16.cuh"

namespace {

using namespace gnn;

constexpr int CH = kBf16Chunk;

// The shared-memory regions (bn2_bf16_smem; ops/bn.py::bn2_bf16_smem_bytes):
// the adjacency [W][W], x3 [W][C1], rows r0, r1 [W][D]; the reverse also r2
// [W][D] and dx2 [W][2D]; then the chunks c0 (the reverse: c1) [W][CH].
struct Bn2Smem {
  uint16_t* adj;
  float* x3;
  float* r0;
  float* r1;
  float* r2;
  float* dx;
  float* c0;
  float* c1;
};

inline size_t bn2_bf16_smem(int W, int D, int F, bool reverse) {
  const size_t C1 = 2 * D + F;
  return 2 * (size_t)W * W + 4 * (size_t)W * (reverse ? C1 + 5 * D + 2 * CH : C1 + 2 * D + CH);
}

__device__ Bn2Smem bn2_layout(void* base, int W, int D, int C1, bool reverse) {
  Bn2Smem m;
  m.adj = static_cast<uint16_t*>(base);
  float* f = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  m.x3 = f;
  f += W * C1;
  m.r0 = f;
  m.r1 = f + W * D;
  f += 2 * W * D;
  m.r2 = reverse ? f : nullptr;
  m.dx = reverse ? f + W * D : nullptr;
  f += reverse ? 3 * W * D : 0;
  m.c0 = f;
  m.c1 = reverse ? f + W * CH : nullptr;
  return m;
}

// h1 (in `h1`, zeroed by the caller), before its bias: every chunk's bf(y0)
// into c0, then its terms bf(y0) * bf(w1), the units ascending.
__device__ void forward_h1(const Bn2Smem& m, float* h1, const float* __restrict__ w0,
                           const float* __restrict__ w1, int W, int D, int C1, int H1,
                           int act0) {
  for (int h0 = 0; h0 < H1; h0 += CH) {
    const int cw = min(CH, H1 - h0);
    __syncthreads();  // x3 and h1 ready; the last chunk's terms read c0
    for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
      const int n = i / cw, h = i % cw;
      m.c0[n * CH + h] =
          bf(act64(act0, bn_dense_row(m.x3 + n * C1, w0 + (size_t)(h0 + h) * (C1 + 1), C1)));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
      const int n = i / D, d = i % D;
      const float* w = w1 + (size_t)d * H1 + h0;
      float acc = h1[i];
      for (int h = 0; h < cw; ++h) acc = fmaf(m.c0[n * CH + h], bf(__ldg(w + h)), acc);
      h1[i] = acc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBf16Threads)
bn2_fwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                    const float* __restrict__ y1, const float* __restrict__ y2,
                    const float* __restrict__ aff, const uint8_t* __restrict__ keep,
                    const float* __restrict__ rT, const float* __restrict__ feats,
                    const float* __restrict__ w0, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ nm,
                    float* __restrict__ y_out, float* __restrict__ agg_out,
                    float* __restrict__ marg, float* __restrict__ msum, int Bl, int W, int D,
                    int F, int H1, float thr, int act0, int act1, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, WD = W * D;
  const Bn2Smem m = bn2_layout(smem_f4, W, D, C1, false);
  const size_t row = (size_t)blockIdx.x * W;
  float* s = m.r0;
  float* h1 = m.r1;   // h1, then y
  bn_stage_adj(m.adj, adj_loop, adj_dep, Bl, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const float v = __fadd_rn(__fmul_rn(__ldg(y1 + row * D + i), __ldg(aff + d)),
                              __ldg(aff + D + d));
    s[i] = v;
    m.x3[n * C1 + d] = drop_rn(mode, da, db, v, keep, (row + n) * C1 + d);
    h1[i] = 0.0f;
  }
  bn_stage_feats(m.x3, feats, keep, W, D, F, mode, da, db);
  __syncthreads();
  bn_margins(s, [&](int n, int d) {
    return __fadd_rn(__fmul_rn(__ldg(y2 + (row + n) * D + d), __ldg(aff + 2 * D + d)),
                     __ldg(aff + 3 * D + d));
  }, nm, marg, W, D, thr);
  bn_aggregate(m.adj, s, m.x3, rT, agg_out, keep, W, D, C1, mode, da, db);
  forward_h1(m, h1, w0, w1, W, D, C1, H1, act0);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const float v = act64(act1, __fadd_rn(h1[i], __ldg(b1 + i % D)));
    h1[i] = v;
    y_out[row * D + i] = v;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int n = 0; n < W; ++n)
      acc = __fadd_rn(acc, __fmul_rn(h1[n * D + d], __ldg(nm + row + n)));
    msum[(size_t)blockIdx.x * D + d] = acc;
  }
}

__global__ void __launch_bounds__(kBf16Threads)
bn2_bwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                    const float* __restrict__ y_prev, const float* __restrict__ y_k,
                    const float* __restrict__ agg, const uint8_t* __restrict__ keep,
                    const float* __restrict__ feats, const float* __restrict__ w0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ ds_in, const float* __restrict__ gsel,
                    const float* __restrict__ bnv, const float* __restrict__ flag,
                    const float* __restrict__ nm, float* __restrict__ ds_out,
                    float* __restrict__ dw0, float* __restrict__ dw1, float* __restrict__ db1,
                    float* __restrict__ dagg_out, float* __restrict__ red, int Bl, int W, int D,
                    int F, int H1, int act0, int act1, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, C = C1 + 1, WD = W * D;
  const Bn2Smem m = bn2_layout(smem_f4, W, D, C1, true);
  const size_t row = (size_t)blockIdx.x * W;
  float* dh1 = m.r0;  // gy, then dh1
  float* ds = m.r1;   // h1, then dx2's state slice, then ds
  float* dg = m.r2;   // bf(dagg)
  float* dw0_r = dw0 + (size_t)blockIdx.x * H1 * C;
  float* dw1_r = dw1 + (size_t)blockIdx.x * D * H1;
  const float f = *flag;
  bn_stage_adj(m.adj, adj_loop, adj_dep, Bl, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const size_t g = row * D + i;
    const float sp = __fadd_rn(__fmul_rn(__ldg(y_prev + g), __ldg(bnv + d)), __ldg(bnv + D + d));
    m.x3[n * C1 + d] = drop_rn(mode, da, db, sp, keep, (row + n) * C1 + d);
    m.x3[n * C1 + D + d] = drop_rn(mode, da, db, __ldg(agg + g), keep, (row + n) * C1 + D + d);
    dh1[i] = bn_gy(bnv, __ldg(ds_in + g), __ldg(gsel + g), __ldg(y_k + g), f,
                   __ldg(nm + row + n), D, d);
    ds[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * WD; i += blockDim.x) m.dx[i] = 0.0f;
  bn_stage_feats(m.x3, feats, keep, W, D, F, mode, da, db);
  forward_h1(m, ds, w0, w1, W, D, C1, H1, act0);
  // dh1 = gy * act1'(h1 + b1); db1 its node sums
  for (int i = threadIdx.x; i < WD; i += blockDim.x)
    dh1[i] = __fmul_rn(dh1[i], act_grad64(act1, __fadd_rn(ds[i], __ldg(b1 + i % D))));
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float sum = 0.0f;
    for (int n = 0; n < W; ++n) sum = __fadd_rn(sum, dh1[n * D + d]);
    db1[(size_t)blockIdx.x * D + d] = sum;
  }
  // ---- the chunks again: h0, y0 (c0), dh0 (c1) and their terms
  for (int h0 = 0; h0 < H1; h0 += CH) {
    const int cw = min(CH, H1 - h0);
    __syncthreads();  // the last chunk's terms read c0, c1
    for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
      const int n = i / cw, h = i % cw;
      const float hv = bn_dense_row(m.x3 + n * C1, w0 + (size_t)(h0 + h) * C, C1);
      float acc = 0.0f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(bf(dh1[n * D + d]), bf(__ldg(w1 + (size_t)d * H1 + h0 + h)), acc);
      m.c0[n * CH + h] = act64(act0, hv);
      m.c1[n * CH + h] = __fmul_rn(acc, act_grad64(act0, hv));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D * cw; i += blockDim.x) {
      const int d = i / cw, h = i % cw;
      float acc = 0.0f;
      for (int n = 0; n < W; ++n)
        acc = __fadd_rn(acc, __fmul_rn(dh1[n * D + d], m.c0[n * CH + h]));
      dw1_r[(size_t)d * H1 + h0 + h] = acc;
    }
    for (int i = threadIdx.x; i < cw * C; i += blockDim.x) {
      const int h = i / C, c = i % C;
      float acc = 0.0f;
      for (int n = 0; n < W; ++n)
        acc = __fadd_rn(acc, c < C1 ? __fmul_rn(m.c1[n * CH + h], m.x3[n * C1 + c])
                                    : m.c1[n * CH + h]);
      dw0_r[(size_t)(h0 + h) * C + c] = acc;
    }
    for (int i = threadIdx.x; i < 2 * WD; i += blockDim.x) {
      const int n = i / (2 * D), c = i % (2 * D);
      float acc = m.dx[i];
      for (int h = 0; h < cw; ++h)
        acc = fmaf(bf(m.c1[n * CH + h]), bf(__ldg(w0 + (size_t)(h0 + h) * C + c)), acc);
      m.dx[i] = acc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * WD; i += blockDim.x)
    bn_split_dx2(m.dx[i], i / (2 * D), i % (2 * D), ds, dg, dagg_out, keep, W, D, C1, mode, da);
  __syncthreads();
  bn_contract(m.adj, dg, ds, ds_out, W, D);  // ds = dx2_s + adjT @ bf(dagg)
  __syncthreads();
  bn_reductions(ds, y_prev, bnv, red, W, D);
}

}  // namespace

extern "C" {

// adj_loop bf16 [Bl, W, W] and adj_dep bf16 [R - Bl, W, W] (either null
// without rows), y1, y2 [R, W, D], aff [2, 2, D], keep uint8 [R, W, 2D + F]
// (null without dropout), rT [R, W, D] (nullable), feats [R, W, F], w0
// [H1, 2D + F + 1], w1 [D, H1], b1 [D], nm [R, W] -> y, agg [R, W, D], marg
// [R, W], msum [R, D]. Returns a cudaError_t code.
int gnn_bn2_forward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep, const float* y1,
                         const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                         const float* feats, const float* w0, const float* w1, const float* b1,
                         const float* nm, float* y, float* agg, float* marg, float* msum, int R,
                         int Bl, int W, int D, int F, int H1, float thr, int act0, int act1,
                         int mode, float da, float db, void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || H1 < 1 || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = bn2_bf16_smem(W, D, F, false);
  cudaError_t err = set_smem(bn2_fwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bn2_fwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0, w1, b1, nm, y, agg, marg, msum, Bl, W,
      D, F, H1, thr, act0, act1, mode, da, db);
  return cudaGetLastError();
}

// As gnn_bn2_forward_bf16's, y_prev, y_k, agg, ds_in, gsel [R, W, D], bnv
// [9, D], flag a device float (0 or 1) -> ds, dagg [R, W, D], dw0
// [R, H1, 2D + F + 1], dw1 [R, D, H1], db1 [R, D], red [R, 2, D] (per block
// row). Returns a cudaError_t code.
int gnn_bn2_backward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep,
                          const float* y_prev, const float* y_k, const float* agg,
                          const uint8_t* keep, const float* feats, const float* w0,
                          const float* w1, const float* b1, const float* ds_in,
                          const float* gsel, const float* bnv, const float* flag,
                          const float* nm, float* ds, float* dw0, float* dw1, float* db1,
                          float* dagg, float* red, int R, int Bl, int W, int D, int F, int H1,
                          int act0, int act1, int mode, float da, float db, void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || H1 < 1 || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = bn2_bf16_smem(W, D, F, true);
  cudaError_t err = set_smem(bn2_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bn2_bwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0, w1, b1, ds_in, gsel, bnv, flag, nm,
      ds, dw0, dw1, db1, dagg, red, Bl, W, D, F, H1, act0, act1, mode, da, db);
  return cudaGetLastError();
}

}  // extern "C"
