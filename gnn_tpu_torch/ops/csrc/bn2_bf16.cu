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
// y0 and x3 enter dw1 and dw0 unrounded (gnn_tpu's _BDT_HI).
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K14 _bn2_fwd_kernel with a bf16 adjacency (hp false, launched by
//       _bn2_fwd_call) -> gnn_bn2_forward_bf16
//   K15 _bn2_bwd_kernel with a bf16 adjacency (hp false, launched by
//       _bn2_bwd_call) -> gnn_bn2_backward_bf16
// The f32 K14 is in bn2_fwd.cu, K15 in bn2_train.cu. Row r < Bl reads
// adj_loop[r], the rest adj_dep[r - Bl], where they lie. The partials are
// each block row's own slices of the outputs. No atomics: a repeat launch is
// bit-identical.
//
// K14_bf16 (simple, not yet tuned: bn_bf16.cu's CTA with K12_bf16's hidden
// chunks): one CTA of 256 threads a block row, the bf16 adjacency staged in
// shared memory beside x3 [W][C1], the rows [W][D] and a hidden chunk
// [W][kBf16Chunk]; every sum over its index ascending, one f32 add a term
// (products of bf values are exact, so fmaf adds them once rounded), the
// elementwise steps as the plain version takes them (__fmul_rn, __fadd_rn),
// the activations through act64: a launch gives its plain version's bits
// (ops/bn.py::bn2_forward_step_bf16_ref), msum included.
//
// K15_bf16 (on tensor-core tiles): one CTA of W/16 warps a block row, warp w
// owning the nodes 16w..16w+15. The contraction adjT @ bf(dagg) runs on
// bf16 tensor-core tiles (mma_bf16.cuh); its sums of a node's few arcs are
// exact in f32 on the sets trained here, so the tiles' own order leaves
// them as they are. The dense layers h0, h1, dy0 and dx2 run on the CUDA
// cores in the plain version's order (the contracted index ascending, one
// f32 add a term; products of bf values are exact): summed in another f32
// order, h0 moves ds, dagg and the block partials dw0 and dw1 past Part B's
// gate at the full set's 1214 block rows, h1 the partials dw0
// (tools/bf16_order.py), and dy0 and dx2 on the tiles moved ds past it on
// the card (each flip of bf(dh0) or bf(dagg) reaches ds). So a launch gives
// its plain version's bits (ops/bn.py::bn2_backward_step_bf16_ref) but ds
// and red, which read the contraction; it is held to it by Part B's gate,
// every output and every block's partials unsummed. The weights are
// rounded, zero-padded and laid out once a call by the wrapper (ops/bn.py::
// bn2_bf16_tiles: bf(w0_aug)^T [Cp][H1p] and bf(w0_aug) [H1p][Cp], bf(w1)^T
// [H1p][Dp]) so that a warp's lanes read adjacent weights, padded hidden
// units adding exact zeros. dw1 and dw0 (f32 operands) stay on the CUDA
// cores, each thread a 2 x 4 tile of outputs summed node by node
// ascending, each product rounded, and db1 and red a thread a column, the
// nodes in order: split sums (a warp's lanes combined in a butterfly, tried
// first) moved db1 and red enough that the h150_bn step's first-layer bias
// grads missed the CPU's. A repeat launch is bit-identical (no atomics, no split sums).
// The hidden units run in sub-chunks of SC = 32 (16 where 32 does not fit).
// A first pass continues each node's h1 sums over the sub-chunk's bf(y0)
// (bf16.cuh::bf_act64), a thread two rows of a column. A second, a lane
// two rows and two units of each 8-unit group of the warp's, recomputes h0
// and runs dy0 (no [W][H1] array in shared memory: two CTAs an SM at the
// h150_bn shapes), forms y0 and dh0 = dy0 * act0'(h0) (act0 and its
// derivative from one float64 evaluation) and continues dx2's sums, a
// thread two rows of a column; then every thread takes the sub-chunk's dw1
// columns and dw0 rows. Shared memory (bn2_bwd_bf16_layout; ops/bn.py::
// bn2_bf16_layout mirrors it): x3a = [drop(x3) | 1] [W][XS] (XS = C | 1, an
// odd stride), h1 then dh1 [W][D], dx2 [W][2D] (then ds in its first D
// columns), and a region that holds y0 (the first pass: bf(y0)) and dh0
// [W][SC] in f32, then the bf16 adjacency [W][W+8] (staged only for the
// contraction at the end) and, where x3a's region cannot take it, bf(dagg)
// [W][Dp+8].
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block row), the f32
// rows, keep bytes and outputs once; the operations 2*D an arc and
// 2*(H1*C + D*H1) a node (K15: the forward's dense layers, dy0, dx2 and ds's
// 2*D an arc in bf16, dw1 and dw0 in fp32) at the dense bf16 tensor-core
// rate (chip_smoke.py::bf16_bounds).

#include "bf16.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gnn;

constexpr int CH = kBf16Chunk;

// K14_bf16's shared-memory regions (bn2_bf16_smem; ops/bn.py::
// bn2_bf16_smem_bytes): the adjacency [W][W], x3 [W][C1], rows r0, r1 [W][D]
// and the chunk c0 [W][CH].
struct Bn2Smem {
  uint16_t* adj;
  float* x3;
  float* r0;
  float* r1;
  float* c0;
};

inline size_t bn2_bf16_smem(int W, int D, int F) {
  const size_t C1 = 2 * D + F;
  return 2 * (size_t)W * W + 4 * (size_t)W * (C1 + 2 * D + CH);
}

__device__ Bn2Smem bn2_layout(void* base, int W, int D, int C1) {
  Bn2Smem m;
  m.adj = static_cast<uint16_t*>(base);
  float* f = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  m.x3 = f;
  f += W * C1;
  m.r0 = f;
  m.r1 = f + W * D;
  m.c0 = f + 2 * W * D;
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
  const Bn2Smem m = bn2_layout(smem_f4, W, D, C1);
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

constexpr int kBn2BwdMaxThreads = 256;

// K15_bf16's shared-memory layout (the kernel's comment above): x3a's row
// stride, the sub-chunk of hidden units, whether bf(dagg) goes into x3a's
// region, and the bytes.
struct Bn2BwdLayout {
  int xs;
  int sc;
  bool dg_in_x3;
  size_t bytes;
};

Bn2BwdLayout bn2_bwd_bf16_layout(int W, int D, int F) {
  Bn2BwdLayout L;
  L.xs = (2 * D + F + 1) | 1;   // odd: a warp's reads of 8 or 16 rows miss no bank
  const size_t rows = 4 * (size_t)W * (L.xs + 3 * D);
  const size_t dg = 2 * (size_t)W * (pad16(D) + 8), adj = 2 * (size_t)W * (W + 8);
  L.dg_in_x3 = dg <= 4 * (size_t)W * L.xs;
  const size_t tail = adj + (L.dg_in_x3 ? 0 : dg);
  for (L.sc = 32;; L.sc = 16) {
    const size_t chunks = 8 * (size_t)W * L.sc;
    L.bytes = rows + (chunks > tail ? chunks : tail);
    if (L.bytes <= (size_t)kMaxSmemBytes || L.sc == 16) break;
  }
  return L;
}

// bf(x[c]) . bf(wT[c][h..h+3]) over c < C ascending, one f32 add a term: x a
// node's x3a row [C] in shared memory, wT the transposed bf16 weight tile
// [Cp][ld] (four hidden units in one 8-byte read).
__device__ __forceinline__ void dot4_x3(float (&acc)[4], const float* x, int C,
                                        const uint16_t* __restrict__ wT, int ld, int h) {
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float xv = bf(x[c]);
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(wT + (size_t)c * ld + h));
    acc[0] = fmaf(xv, __uint_as_float(w.x << 16), acc[0]);
    acc[1] = fmaf(xv, __uint_as_float(w.x & 0xffff0000u), acc[1]);
    acc[2] = fmaf(xv, __uint_as_float(w.y << 16), acc[2]);
    acc[3] = fmaf(xv, __uint_as_float(w.y & 0xffff0000u), acc[3]);
  }
}

// act64(act, x) into y and act_grad64(act, x) into g, the float64
// transcendental evaluated once for both (the same bits as the two calls).
__device__ __forceinline__ void act_and_grad64(int act, float x, float& y, float& g) {
  const double d = x;
  switch (act) {
    case kTanh: {
      const double t = tanh(d);
      y = static_cast<float>(t);
      g = static_cast<float>(__dsub_rn(1.0, __dmul_rn(t, t)));
      return;
    }
    case kSelu: {
      constexpr double kScale = 1.0507009873554805, kAlpha = 1.6732632423543772;
      const double e = exp(fmin(d, 0.0));
      y = static_cast<float>(__dmul_rn(kScale, d > 0.0 ? d : __dmul_rn(kAlpha, __dsub_rn(e, 1.0))));
      g = d > 0.0 ? static_cast<float>(kScale) : static_cast<float>(__dmul_rn(kScale * kAlpha, e));
      return;
    }
    default:
      y = act64(act, x);
      g = act_grad64(act, x);
  }
}

__global__ void __launch_bounds__(kBn2BwdMaxThreads, 2)
bn2_bwd_bf16_kernel(const uint16_t* __restrict__ adj_loop, const uint16_t* __restrict__ adj_dep,
                    const float* __restrict__ y_prev, const float* __restrict__ y_k,
                    const float* __restrict__ agg, const uint8_t* __restrict__ keep,
                    const float* __restrict__ feats, const uint16_t* __restrict__ w0t,
                    const uint16_t* __restrict__ w1t, const float* __restrict__ b1,
                    const float* __restrict__ ds_in, const float* __restrict__ gsel,
                    const float* __restrict__ bnv, const float* __restrict__ flag,
                    const float* __restrict__ nm, float* __restrict__ ds_out,
                    float* __restrict__ dw0, float* __restrict__ dw1, float* __restrict__ db1,
                    float* __restrict__ dagg_out, float* __restrict__ red, int Bl, int W, int D,
                    int F, int H1, int act0, int act1, int mode, float da, float db,
                    Bn2BwdLayout L) {
  extern __shared__ float4 smem_f4[];
  const int C1 = 2 * D + F, C = C1 + 1, D2 = 2 * D, SC = L.sc, XS = L.xs;
  const int Dp = pad16(D), H1p = pad16(H1);
  float* x3a = reinterpret_cast<float*>(smem_f4);   // [W][XS]
  float* dh1 = x3a + W * XS;                        // [W][D]: h1, then dh1
  float* dx = dh1 + W * D;                          // [W][2D]: dx2, then ds
  float* y0s = dx + W * D2;                         // [W][SC]: bf(y0), then y0
  float* dh0s = y0s + W * SC;                       // [W][SC]
  uint16_t* adj = reinterpret_cast<uint16_t*>(y0s); // [W][W+8], at the end
  uint16_t* dg = L.dg_in_x3 ? reinterpret_cast<uint16_t*>(x3a) : adj + W * (W + 8);
  const int DGS = Dp + 8;                           // dg's row stride
  const size_t row = (size_t)blockIdx.x * W;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  float* dw0_r = dw0 + (size_t)blockIdx.x * H1 * C;
  float* dw1_r = dw1 + (size_t)blockIdx.x * D * H1;
  const float f = *flag;

  // x3a = [drop(s_prev) | drop(agg) | drop(feats) | 1]; h1 and dx2 zeroed
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const size_t gi = row * D + i;
    const float sp = __fadd_rn(__fmul_rn(__ldg(y_prev + gi), __ldg(bnv + d)), __ldg(bnv + D + d));
    x3a[n * XS + d] = drop_rn(mode, da, db, sp, keep, (row + n) * C1 + d);
    x3a[n * XS + D + d] = drop_rn(mode, da, db, __ldg(agg + gi), keep, (row + n) * C1 + D + d);
    dh1[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) {
    const int n = i / F, c = i % F;
    x3a[n * XS + D2 + c] =
        drop_rn(mode, da, db, __ldg(feats + row * F + i), keep, (row + n) * C1 + D2 + c);
  }
  for (int n = threadIdx.x; n < W; n += blockDim.x) x3a[n * XS + C1] = 1.0f;
  for (int i = threadIdx.x; i < W * D2; i += blockDim.x) dx[i] = 0.0f;
  __syncthreads();

  // h1 = bf(act0(h0)) . bf(w1) on the warp's rows, sub-chunk by sub-chunk,
  // the units ascending (a lane the rows n and n + 8 of a column: the lanes'
  // weights side by side in a row of bf(w1)^T)
  for (int s0 = 0; s0 < H1p; s0 += SC) {
    const int sw = min(SC, H1p - s0), units = min(sw, H1 - s0);
    for (int i = lane; i < 16 * (sw / 4); i += 32) {
      const int n = m0 + i / (sw / 4), h = 4 * (i % (sw / 4));
      float h0[4];
      dot4_x3(h0, x3a + n * XS, C, w0t, H1p, s0 + h);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        y0s[n * SC + h + v] = h + v < units ? bf_act64(act0, h0[v]) : 0.0f;
    }
    __syncwarp();
    for (int i = lane; i < 8 * D; i += 32) {
      const int n = m0 + i / D, d = i % D;
      const uint16_t* w = w1t + (size_t)s0 * Dp + d;
      float acc0 = dh1[n * D + d], acc1 = dh1[(n + 8) * D + d];
      for (int u = 0; u < units; ++u) {
        const float wv = bf16_value(__ldg(w + (size_t)u * Dp));
        acc0 = fmaf(y0s[n * SC + u], wv, acc0);
        acc1 = fmaf(y0s[(n + 8) * SC + u], wv, acc1);
      }
      dh1[n * D + d] = acc0;
      dh1[(n + 8) * D + d] = acc1;
    }
    __syncwarp();
  }
  // dh1 = gy * act1'(h1 + b1)
  for (int i = lane; i < 16 * D; i += 32) {
    const int n = m0 + i / D, d = i % D;
    const size_t gi = (row + n) * D + d;
    const float gy = bn_gy(bnv, __ldg(ds_in + gi), __ldg(gsel + gi), __ldg(y_k + gi), f,
                           __ldg(nm + row + n), D, d);
    dh1[n * D + d] = __fmul_rn(gy, act_grad64(act1, __fadd_rn(dh1[n * D + d], __ldg(b1 + d))));
  }
  __syncthreads();   // dh1 of every row: the dw1 products read them

  // the sub-chunks again, on the warp's 16 rows (a lane the rows m0 + g and
  // m0 + g + 8, units 2q and 2q + 1 of each 8-unit group): dy0 = bf(dh1) .
  // bf(w1) and h0 on the CUDA cores in the plain order, y0 and dh0 = dy0 *
  // act0'(h0); then dx2 += bf(dh0) .
  // bf(w0_aug[:, :2D]) on the CUDA cores in the plain order (a thread the
  // rows r and r + 8 of a column: the lanes' weights side by side in a row
  // of bf(w0_aug)); then the sub-chunk's dw1 columns and dw0 rows on every
  // thread
  const int g = lane >> 2, q = lane & 3, Cp = pad16(C);
  const uint16_t* w0r = w0t + (size_t)Cp * H1p;   // bf(w0_aug) [H1p][Cp]
  for (int s0 = 0; s0 < H1p; s0 += SC) {
    const int sw = min(SC, H1p - s0), nt = sw / 8, units = min(sw, H1 - s0);
    float dy[4][4] = {}, h0[4][4] = {};
    for (int d = 0; d < D; ++d) {   // dy0 = bf(dh1) . bf(w1), d ascending
      const float g0 = bf(dh1[(m0 + g) * D + d]), g1 = bf(dh1[(m0 + g + 8) * D + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nt) {
          const uint16_t* wc = w1t + (size_t)(s0 + 8 * j + 2 * q) * Dp + d;
          const float wl = bf16_value(__ldg(wc)), wh = bf16_value(__ldg(wc + Dp));
          dy[j][0] = fmaf(g0, wl, dy[j][0]);
          dy[j][1] = fmaf(g0, wh, dy[j][1]);
          dy[j][2] = fmaf(g1, wl, dy[j][2]);
          dy[j][3] = fmaf(g1, wh, dy[j][3]);
        }
      }
    }
    for (int c = 0; c < C; ++c) {   // h0 = bf(x3a) . bf(w0_aug), c ascending
      const float x0 = bf(x3a[(m0 + g) * XS + c]), x1 = bf(x3a[(m0 + g + 8) * XS + c]);
      const uint16_t* wr = w0t + (size_t)c * H1p + s0 + 2 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nt) {
          const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(wr + 8 * j));
          const float wl = __uint_as_float(w << 16), wh = __uint_as_float(w & 0xffff0000u);
          h0[j][0] = fmaf(x0, wl, h0[j][0]);
          h0[j][1] = fmaf(x0, wh, h0[j][1]);
          h0[j][2] = fmaf(x1, wl, h0[j][2]);
          h0[j][3] = fmaf(x1, wh, h0[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = m0 + c_row(e), u = 8 * j + c_col(e);
          float y = 0.0f, d0 = 0.0f;
          if (s0 + u < H1) {
            float gr;
            act_and_grad64(act0, h0[j][e], y, gr);
            d0 = __fmul_rn(dy[j][e], gr);
          }
          y0s[n * SC + u] = y;
          dh0s[n * SC + u] = d0;
        }
      }
    }
    __syncwarp();
    for (int i = lane; i < 8 * D2; i += 32) {
      const int r = m0 + i / D2, c = i % D2;
      const uint16_t* w = w0r + (size_t)s0 * Cp + c;
      float acc0 = dx[r * D2 + c], acc1 = dx[(r + 8) * D2 + c];
      for (int u = 0; u < units; ++u) {
        const float wv = bf16_value(__ldg(w + (size_t)u * Cp));
        acc0 = fmaf(bf(dh0s[r * SC + u]), wv, acc0);
        acc1 = fmaf(bf(dh0s[(r + 8) * SC + u]), wv, acc1);
      }
      dx[r * D2 + c] = acc0;
      dx[(r + 8) * D2 + c] = acc1;
    }
    __syncthreads();   // the sub-chunk's y0 and dh0 of every row
    {
      // tiles of 2 hidden units x 4 columns: dw1's columns d (y0 x dh1),
      // then dw0's columns c (dh0 x x3a), each summed over the nodes in order
      const int hp = sw / 2, t1 = hp * ((D + 3) / 4), t0 = hp * ((C + 3) / 4);
      for (int t = threadIdx.x; t < t1 + t0; t += blockDim.x) {
        const bool w1_tile = t < t1;
        const int u = w1_tile ? t : t - t1, O = w1_tile ? D : C;
        const int h = 2 * (u % hp), o = 4 * (u / hp);
        const float* left = w1_tile ? y0s : dh0s;
        const float* right = w1_tile ? dh1 : x3a;
        const int rs = w1_tile ? D : XS;
        float acc[2][4] = {};
        for (int n = 0; n < W; ++n) {
          const float l0 = left[n * SC + h], l1 = left[n * SC + h + 1];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float r = o + v < O ? right[n * rs + o + v] : 0.0f;
            acc[0][v] = __fadd_rn(acc[0][v], __fmul_rn(l0, r));
            acc[1][v] = __fadd_rn(acc[1][v], __fmul_rn(l1, r));
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int hh = s0 + h + i;
          if (hh >= H1) continue;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (o + v >= O) continue;
            if (w1_tile) {
              dw1_r[(size_t)(o + v) * H1 + hh] = acc[i][v];
            } else {
              dw0_r[(size_t)hh * C + o + v] = acc[i][v];
            }
          }
        }
      }
    }
    __syncthreads();   // before the next sub-chunk's y0 and dh0
  }

  // dx2 through the dropout's derivative: ds (dx's first D columns), dagg
  // and bf(dagg); the adjacency staged for the contraction
  stage_padded(adj, (int)blockIdx.x < Bl ? adj_loop + row * W : adj_dep + (row - (size_t)Bl * W) * W,
               W);
  for (int i = threadIdx.x; i < W * D2; i += blockDim.x) {
    const int n = i / D2, c = i % D2;
    float v = dx[i];
    if (mode != kNoDrop) v = __fmul_rn(v, keep[(row + n) * C1 + c] != 0 ? da : 0.0f);
    dx[i] = v;
    if (c >= D) {
      dagg_out[(row + n) * D + c - D] = v;
      dg[n * DGS + c - D] = bf16_bits(v);
    }
  }
  for (int i = threadIdx.x; i < W * (DGS - D); i += blockDim.x)
    dg[(i / (DGS - D)) * DGS + D + i % (DGS - D)] = 0;
  __syncthreads();
  // ds = dx2_s + adjT @ bf(dagg), the destinations contracted, the warp's rows
  for (int nt = 0; nt < Dp; nt += 16) {
    float acc[2][4] = {};
    for (int ks = 0; ks < W; ks += 16) {
      uint32_t a[4], bb[4];
      lda_rows(a, adj, W + 8, m0, ks);
      ldb_rows(bb, dg, DGS, ks, nt);
      mma_bf16(acc[0], a, bb[0], bb[1]);
      mma_bf16(acc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = nt + 8 * t + c_col(e), n = m0 + c_row(e);
        if (d < D) {
          const float v = __fadd_rn(dx[n * D2 + d], acc[t][e]);
          dx[n * D2 + d] = v;
          ds_out[(row + n) * D + d] = v;
        }
      }
  }
  __syncthreads();
  // db1 [D] and red [2][D] of the block row: a thread a column, the nodes
  // in order (the plain version's node sums)
  for (int col = threadIdx.x; col < 3 * D; col += blockDim.x) {
    const int d = col % D;
    float acc = 0.0f;
    for (int n = 0; n < W; ++n) {
      if (col < D) {
        acc = __fadd_rn(acc, dh1[n * D + d]);
      } else if (col < 2 * D) {
        acc = __fadd_rn(acc, dx[n * D2 + d]);
      } else {
        const float xp = __fmul_rn(
            __fsub_rn(__ldg(y_prev + (row + n) * D + d), __ldg(bnv + 7 * D + d)),
            __ldg(bnv + 8 * D + d));
        acc = __fadd_rn(acc, __fmul_rn(dx[n * D2 + d], xp));
      }
    }
    if (col < D) {
      db1[(size_t)blockIdx.x * D + d] = acc;
    } else {
      red[((size_t)blockIdx.x * 2 + (col >= 2 * D)) * D + d] = acc;
    }
  }
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
  const size_t bytes = bn2_bf16_smem(W, D, F);
  cudaError_t err = set_smem(bn2_fwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  bn2_fwd_bf16_kernel<<<R, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0, w1, b1, nm, y, agg, marg, msum, Bl, W,
      D, F, H1, thr, act0, act1, mode, da, db);
  return cudaGetLastError();
}

// As gnn_bn2_forward_bf16's, y_prev, y_k, agg, ds_in, gsel [R, W, D], bnv
// [9, D], flag a device float (0 or 1), but the weights as bf16 tiles
// (ops/bn.py::bn2_bf16_tiles; Cp, Dp, H1p: C = 2D + F + 1, D and H1 up to a
// multiple of 16): w0t = [bf(w0_aug)^T [Cp, H1p] | bf(w0_aug) [H1p, Cp]],
// w1t = bf(w1)^T [H1p, Dp] ->
// ds, dagg [R, W, D], dw0 [R, H1, 2D + F + 1], dw1 [R, D, H1], db1 [R, D],
// red [R, 2, D] (per block row). Returns a cudaError_t code.
int gnn_bn2_backward_bf16(const uint16_t* adj_loop, const uint16_t* adj_dep,
                          const float* y_prev, const float* y_k, const float* agg,
                          const uint8_t* keep, const float* feats, const uint16_t* w0t,
                          const uint16_t* w1t, const float* b1, const float* ds_in,
                          const float* gsel, const float* bnv, const float* flag,
                          const float* nm, float* ds, float* dw0, float* dw1, float* db1,
                          float* dagg, float* red, int R, int Bl, int W, int D, int F, int H1,
                          int act0, int act1, int mode, float da, float db, void* stream) {
  if (!bn_bf16_ok(R, Bl, W, D, F) || H1 < 1 || (mode != kNoDrop && keep == nullptr))
    return cudaErrorInvalidValue;
  const Bn2BwdLayout L = bn2_bwd_bf16_layout(W, D, F);
  cudaError_t err = set_smem(bn2_bwd_bf16_kernel, L.bytes);
  if (err != cudaSuccess) return err;
  bn2_bwd_bf16_kernel<<<R, 2 * W, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0t, w1t, b1, ds_in, gsel, bnv, flag, nm,
      ds, dw0, dw1, db1, dagg, red, Bl, W, D, F, H1, act0, act1, mode, da, db, L);
  return cudaGetLastError();
}

}  // extern "C"
