// K16_bf16 and K17_bf16, the typed BatchNorm-training iteration of composite
// (per-node-type) GNNs and its reverse on a bf16 block adjacency, for Hopper
// (sm_90a): gnn_tpu's `hp = False` branch of _bnT_fwd_kernel and
// _bnT_bwd_kernel (pallas_typed.py:84-136, :200-273).
//
// They are K1_bf16 and K2_bf16 (bn_bf16.cu) with a node type per node, as
// K16/K17 (bn_typed.cu) are K1/K2 with one: node n of type t(n) takes type
// t(n)'s affine and BatchNorm coefficients, only rows [t*D, (t+1)*D) of the
// stacked weights w_stk [T*D, C] (C = 2D + F + 1, [Ws | Wa | Wf | b] of each
// type) and type t(n)'s activation, and the moment and reduction sums are
// split by type; bf as in bf16.cuh:
//   K16  s = y1 * scale1[t] + shift1[t], s_old = y2 * scale2[t] + shift2[t]
//        marg, agg = adjT^T @ bf(s) (+ rT), x3 = drop([s | agg | feats]) as K1_bf16
//        y = act_t(bf([x3 | 1]) @ bf(w_stk[t])^T),  msum[t'] = sum over type-t' nodes of y * nm
//   K17  gy from bnv[t] as K2_bf16's,  dh = gy * act_t'(h)
//        dw[t rows] = dh^T @ [x3 | 1]            f32 operands (gnn_tpu's _BDT_HI)
//        dx2 = bf(dh) @ bf(w_stk[t][:, :2D]),  dagg, ds as K2_bf16's
//        red[t'] = (sum ds, sum ds * x_hat_prev) over type-t' nodes
// gnn_tpu multiplies every node by all T weight slabs and selects with a
// one-hot mask; another type's rows meet the node only multiplied by 0, so
// a node's own rows give the same function. Types are indices (int32, 0 on
// padded nodes), type t's activation code the byte acts[t] of a device
// array, so any number of types runs. Every sum runs over its index
// ascending, one f32 add a term; the per-type sums (msum, dw, red) run over
// the block's nodes in order, each type's nodes only; the elementwise steps
// as the plain versions take them: a launch gives the plain versions' bits
// (ops/typed.py::bnT_{forward,backward}_step_bf16_ref), the per-block
// partials included.
//
// Replaces gnn_tpu/ops/pallas_typed.py:
//   K16 _bnT_fwd_kernel with a bf16 adjacency (hp false, launched by
//       _bnT_fwd_call) -> gnn_bnT_forward_bf16
//   K17 _bnT_bwd_kernel with a bf16 adjacency (hp false, launched by
//       _bnT_bwd_call) -> gnn_bnT_backward_bf16
// The f32 K16/K17 are in bn_typed.cu. Row r < Bl reads adj_loop[r], the rest
// adj_dep[r - Bl], where they lie.
//
// Design (bn_bf16.cu's CTA; simple, not yet tuned): one CTA of 256 threads a
// block row, the bf16 adjacency staged in shared memory (2*W*W bytes) beside
// x3 [W][C1], three rows [W][D] and the block row's node types [W]; the
// stacked weights read through the read-only cache. No atomics: a repeat
// launch is bit-identical.
//
// Bound: K1_bf16's and K2_bf16's (chip_smoke.py::bf16_bounds): the bf16
// adjacency read once, the f32 rows, types, keep bytes and outputs once; the
// operations 2*D an arc (K17: twice that) and each node's own type's dense
// layer 2*D*C (K17: the dense layer and dx2 in bf16, dw in fp32).

#include "bf16.cuh"

namespace {

using namespace gnn;

// The shared-memory regions (bnT_bf16_smem; ops/typed.py::
// bnT_bf16_smem_bytes): the adjacency [W][W], x3 [W][C1], rows r0, r1, r2
// [W][D], the node types [W].
struct BnTBf16Smem {
  uint16_t* adj;
  float* x3;
  float* r0;
  float* r1;
  float* r2;
  int* ty;
};

inline size_t bnT_bf16_smem(int W, int D, int F) {
  return 2 * (size_t)W * W + 4 * (size_t)W * (2 * D + F + 3 * D + 1);
}

// The layout, with block row blockIdx.x's adjacency and node types staged
// (the caller synchronizes).
__device__ BnTBf16Smem bnT_stage(void* base, const uint16_t* __restrict__ adj_loop,
                                 const uint16_t* __restrict__ adj_dep,
                                 const int* __restrict__ types, int Bl, int W, int D, int C1) {
  BnTBf16Smem m;
  m.adj = static_cast<uint16_t*>(base);
  m.x3 = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  m.r0 = m.x3 + W * C1;
  m.r1 = m.r0 + W * D;
  m.r2 = m.r1 + W * D;
  m.ty = reinterpret_cast<int*>(m.r2 + W * D);
  bn_stage_adj(m.adj, adj_loop, adj_dep, Bl, W);
  for (int n = threadIdx.x; n < W; n += blockDim.x)
    m.ty[n] = __ldg(types + (size_t)blockIdx.x * W + n);
  return m;
}

__global__ void __launch_bounds__(kBf16Threads)
bnT_fwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                    const float* __restrict__ y1, const float* __restrict__ y2,
                    const float* __restrict__ aff, const int* __restrict__ types,
                    const uint8_t* __restrict__ keep, const float* __restrict__ rT,
                    const float* __restrict__ feats, const float* __restrict__ w_stk,
                    const float* __restrict__ nm, float* __restrict__ y_out,
                    float* __restrict__ agg_out, float* __restrict__ marg,
                    float* __restrict__ msum, int Bl, int W, int D, int F, int T, float thr,
                    const uint8_t* __restrict__ acts, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, WD = W * D, TD = T * D;
  const BnTBf16Smem m = bnT_stage(smem_f4, adj_loop, adj_dep, types, Bl, W, D, C1);
  const size_t row = (size_t)blockIdx.x * W;
  float* s = m.r0;
  float* y = m.r1;
  __syncthreads();
  // aff [2][2][T][D]: (scale, shift) of y1, then of y2, each node its type's
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const int a = m.ty[n] * D + d;
    const float v = __fadd_rn(__fmul_rn(__ldg(y1 + row * D + i), __ldg(aff + a)),
                              __ldg(aff + TD + a));
    s[i] = v;
    m.x3[n * C1 + d] = drop_rn(mode, da, db, v, keep, (row + n) * C1 + d);
  }
  bn_stage_feats(m.x3, feats, keep, W, D, F, mode, da, db);
  __syncthreads();
  bn_margins(s, [&](int n, int d) {
    const int a = m.ty[n] * D + d;
    return __fadd_rn(__fmul_rn(__ldg(y2 + (row + n) * D + d), __ldg(aff + 2 * TD + a)),
                     __ldg(aff + 3 * TD + a));
  }, nm, marg, W, D, thr);
  bn_aggregate(m.adj, s, m.x3, rT, agg_out, keep, W, D, C1, mode, da, db);
  __syncthreads();
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, o = i % D, t = m.ty[n];
    const float v = act64(__ldg(acts + t),
                          bn_dense_row(m.x3 + n * C1, w_stk + (size_t)(t * D + o) * (C1 + 1), C1));
    y[i] = v;
    y_out[row * D + i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TD; i += blockDim.x) {
    const int t = i / D, d = i % D;
    float acc = 0.0f;
    for (int n = 0; n < W; ++n)
      if (m.ty[n] == t) acc = __fadd_rn(acc, __fmul_rn(y[n * D + d], __ldg(nm + row + n)));
    msum[(size_t)blockIdx.x * TD + i] = acc;
  }
}

__global__ void __launch_bounds__(kBf16Threads)
bnT_bwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                    const float* __restrict__ y_prev, const float* __restrict__ y_k,
                    const float* __restrict__ agg, const int* __restrict__ types,
                    const uint8_t* __restrict__ keep, const float* __restrict__ feats,
                    const float* __restrict__ w_stk, const float* __restrict__ ds_in,
                    const float* __restrict__ gsel, const float* __restrict__ bnv,
                    const float* __restrict__ flag, const float* __restrict__ nm,
                    float* __restrict__ ds_out, float* __restrict__ dw,
                    float* __restrict__ dagg_out, float* __restrict__ red, int Bl, int W, int D,
                    int F, int T, const uint8_t* __restrict__ acts, int mode, float da,
                    float db) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, C = C1 + 1, WD = W * D, TD = T * D;
  const BnTBf16Smem m = bnT_stage(smem_f4, adj_loop, adj_dep, types, Bl, W, D, C1);
  const size_t row = (size_t)blockIdx.x * W;
  float* dh = m.r0;   // gy, then dh
  float* ds = m.r1;   // dx2's state slice, then ds
  float* dg = m.r2;   // bf(dagg)
  const float f = *flag;
  __syncthreads();
  // bnv [T][9][D]: each node its type's rows
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const float* bv = bnv + (size_t)m.ty[n] * 9 * D;
    const size_t g = row * D + i;
    const float sp = __fadd_rn(__fmul_rn(__ldg(y_prev + g), __ldg(bv + d)), __ldg(bv + D + d));
    m.x3[n * C1 + d] = drop_rn(mode, da, db, sp, keep, (row + n) * C1 + d);
    m.x3[n * C1 + D + d] = drop_rn(mode, da, db, __ldg(agg + g), keep, (row + n) * C1 + D + d);
    dh[i] = bn_gy(bv, __ldg(ds_in + g), __ldg(gsel + g), __ldg(y_k + g), f, __ldg(nm + row + n),
                  D, d);
  }
  bn_stage_feats(m.x3, feats, keep, W, D, F, mode, da, db);
  __syncthreads();
  for (int i = threadIdx.x; i < WD; i += blockDim.x) {
    const int n = i / D, o = i % D, t = m.ty[n];
    dh[i] = __fmul_rn(dh[i], act_grad64(__ldg(acts + t),
                                        bn_dense_row(m.x3 + n * C1,
                                                     w_stk + (size_t)(t * D + o) * C, C1)));
  }
  __syncthreads();
  // dw [T*D][C] = dh^T @ [x3 | 1] into each node's type's rows, the nodes
  // ascending (per-block partials)
  float* dw_r = dw + (size_t)blockIdx.x * TD * C;
  for (int i = threadIdx.x; i < TD * C; i += blockDim.x) {
    const int t = i / (D * C), o = i / C % D, c = i % C;
    float acc = 0.0f;
    for (int n = 0; n < W; ++n)
      if (m.ty[n] == t)
        acc = __fadd_rn(acc, c < C1 ? __fmul_rn(dh[n * D + o], m.x3[n * C1 + c]) : dh[n * D + o]);
    dw_r[i] = acc;
  }
  // dx2 = bf(dh) @ bf(w_stk[t][:, :2D]), the outputs ascending, through dm
  for (int i = threadIdx.x; i < 2 * WD; i += blockDim.x) {
    const int n = i / (2 * D), c = i % (2 * D);
    const float* w = w_stk + (size_t)m.ty[n] * D * C + c;
    float acc = 0.0f;
    for (int o = 0; o < D; ++o) acc = fmaf(bf(dh[n * D + o]), bf(__ldg(w + (size_t)o * C)), acc);
    bn_split_dx2(acc, n, c, ds, dg, dagg_out, keep, W, D, C1, mode, da);
  }
  __syncthreads();
  bn_contract(m.adj, dg, ds, ds_out, W, D);  // ds = dx2_s + adjT @ bf(dagg)
  __syncthreads();
  // red [T][2][D]: each type's (sum ds, sum ds * x_hat_prev), its nodes in order
  for (int i = threadIdx.x; i < TD; i += blockDim.x) {
    const int t = i / D, d = i % D;
    const float* bv = bnv + (size_t)t * 9 * D;
    float s1 = 0.0f, s2 = 0.0f;
    for (int n = 0; n < W; ++n) {
      if (m.ty[n] != t) continue;
      const float v = ds[n * D + d];
      const float xp = __fmul_rn(__fsub_rn(__ldg(y_prev + (row + n) * D + d), __ldg(bv + 7 * D + d)),
                                 __ldg(bv + 8 * D + d));
      s1 = __fadd_rn(s1, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, xp));
    }
    red[((size_t)blockIdx.x * T + t) * 2 * D + d] = s1;
    red[(((size_t)blockIdx.x * T + t) * 2 + 1) * D + d] = s2;
  }
}

}  // namespace

extern "C" {

// adj_loop bf16 [Bl, W, W] and adj_dep bf16 [R - Bl, W, W] (either null
// without rows), y1, y2 [R, W, D], aff [2, 2, T, D], types int32 [R, W],
// keep uint8 [R, W, 2D + F] (null without dropout), rT [R, W, D] (nullable),
// feats [R, W, F], w_stk [T*D, 2D + F + 1], nm [R, W], acts uint8 [T] on the
// device -> y, agg [R, W, D], marg [R, W], msum [R, T, D]. Returns a
// cudaError_t code.
int gnn_bnT_forward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep, const float* y1,
                         const float* y2, const float* aff, const int* types,
                         const uint8_t* keep, const float* rT, const float* feats,
                         const float* w_stk, const float* nm, float* y, float* agg, float* marg,
                         float* msum, int R, int Bl, int W, int D, int F, int T, float thr,
                         const uint8_t* acts, int mode, float da, float db, void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || T < 1 || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = bnT_bf16_smem(W, D, F);
  cudaError_t err = set_smem(bnT_fwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bnT_fwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, y, agg, marg, msum, Bl,
      W, D, F, T, thr, acts, mode, da, db);
  return cudaGetLastError();
}

// As gnn_bnT_forward_bf16's, y_prev, y_k, agg, ds_in, gsel [R, W, D], bnv
// [T, 9, D], flag a device float (0 or 1) -> ds, dagg [R, W, D], dw
// [R, T*D, 2D + F + 1], red [R, T, 2, D] (per block row). Returns a
// cudaError_t code.
int gnn_bnT_backward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep,
                          const float* y_prev, const float* y_k, const float* agg,
                          const int* types, const uint8_t* keep, const float* feats,
                          const float* w_stk, const float* ds_in, const float* gsel,
                          const float* bnv, const float* flag, const float* nm, float* ds,
                          float* dw, float* dagg, float* red, int R, int Bl, int W, int D, int F,
                          int T, const uint8_t* acts, int mode, float da, float db,
                          void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || T < 1 || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = bnT_bf16_smem(W, D, F);
  cudaError_t err = set_smem(bnT_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bnT_bwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk, ds_in, gsel, bnv, flag, nm,
      ds, dw, dagg, red, Bl, W, D, F, T, acts, mode, da, db);
  return cudaGetLastError();
}

}  // extern "C"
