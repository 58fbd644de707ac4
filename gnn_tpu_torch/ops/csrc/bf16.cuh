// Device code shared by the bf16-adjacency variants of the two-layer eval
// kernels (fused2_bf16.cu: K9_bf16, eval_loop2_bwd_bf16.cu: K11_bf16; its
// rounding and activations also loop2_bf16.cu: K10_bf16), gnn_tpu's `hp = False` branch
// (pallas_fused.py:104-217, :1127-1169, :1390-1470); its rounding, the
// activations and the dropout also serve eval_loop_bf16.cu (K3_bf16,
// K4_bf16), eval_loop_bwd_bf16.cu (K5_bf16), train_loop_bf16.cu (K6-K8_bf16)
// and train_loop2_bf16.cu (K12_bf16, K13_bf16), and its BatchNorm-row
// helpers (bn_*) bn_bf16.cu (K1_bf16, K2_bf16), bn2_bf16.cu (K14_bf16,
// K15_bf16) and bn_typed_bf16.cu (K16_bf16, K17_bf16).
//
// Write bf(x) for x rounded to bf16 to nearest even and used as f32. One
// iteration on a block of W nodes, node-major, w20 = [W0s; W0a] [2H1, D]:
//   U  = bf(s) @ bf(w20)^T                  [W, 2H1]
//   A  = adjT^T @ bf(U_a)                   adjT [W(src), W(dst)] in bf16
//   h0 = (U_s + A) + fT (+ rT)              fT, rT f32 [W, H1]
//   h1 = bf(act0(h0)) @ bf(w1)^T + b1       w1 [D, H1]
//   s' = act1(h1) * scale + shift
// Every product is of two bf values, so exact in f32, and in the kernels
// built on this header each sum runs over its contracted index ascending (A
// over the sources, h1 over the hidden units chunk by chunk), one f32 add a
// term: the order of the plain versions (ops/fused2.py), so such a kernel
// gives their bits. K10_bf16 (loop2_bf16.cu) and K15_bf16 (bn2_bf16.cu's
// reverse kernel) take only the rounding, the activations and the BatchNorm
// helpers from here: their aggregation (K10_bf16's adjT^T @ bf(U_a),
// K15_bf16's adjT @ bf(dagg)) runs on bf16 tensor-core tiles
// (mma_bf16.cuh), which add in the tensor cores' own order, so they are
// held to their plain versions by Part B's gate and not bit for bit; their
// dense layers keep the plain order. The
// activations are evaluated in float64 and rounded to f32 once
// (fused2.act64): the card and the CPU then take the same bf16 rounding of
// y0.
//
// Design of the CUDA-core iteration (simple, not yet tuned; K9_bf16 and
// K11_bf16): one CTA of 256 threads a block. The bf16 adjacency is staged in
// shared memory once (2*W*W bytes, 32 KiB at W = 128), beside the state and
// h1 rows [W][D]; the hidden units run in chunks of kBf16Chunk = 32: U's two
// halves of the chunk, then A and y0, then the chunk's terms of h1. Weights
// are read through the read-only cache. No atomics: a repeat launch is
// bit-identical.

#pragma once

#include "common.cuh"

namespace gnn {

constexpr int kBf16Threads = 256;
constexpr int kBf16Chunk = 32;  // hidden units a chunk (fused2.BF16_CHUNK)

// bf(x): round to nearest even bf16, back to f32 (NaN to the quiet NaN).
__device__ __forceinline__ float bf(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// A bf16 value's bits as f32.
__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// The activation in float64, rounded to f32 once (fused2.act64).
__device__ __forceinline__ float act64(int act, float x) {
  const double d = x;
  switch (act) {
    case kTanh:
      return static_cast<float>(tanh(d));
    case kRelu:
      return static_cast<float>(fmax(d, 0.0));
    case kSelu:
      return static_cast<float>(
          __dmul_rn(1.0507009873554805,
                    d > 0.0 ? d : __dmul_rn(1.6732632423543772,
                                            __dsub_rn(exp(fmin(d, 0.0)), 1.0))));
    default:
      return x;
  }
}

// bf(act64(act, x)), the float64 evaluation only where the f32 one
// (common.cuh::activate: tanhf and expf within 2 f32 ulps, selu's e - 1 within
// 2^-22 absolute; e = 2^-20 |y| + 2^-21 covers both) lies within e of a bf16
// rounding midpoint; elsewhere the two round alike (K10_bf16's and
// K15_bf16's bf(y0); about 0.2% of selu and tanh values of unit scale fall
// back).
__device__ __forceinline__ float bf_act64(int act, float x) {
  const float y = activate(act, x), e = fmaf(9.5367431640625e-07f, fabsf(y), 4.76837158203125e-07f);
  const float lo = bf(y - e);
  return lo == bf(y + e) ? lo : bf(act64(act, x));
}

// d act / d h in float64, rounded to f32 once (fused2.act_grad64).
__device__ __forceinline__ float act_grad64(int act, float h) {
  const double d = h;
  switch (act) {
    case kTanh: {
      const double t = tanh(d);
      return static_cast<float>(__dsub_rn(1.0, __dmul_rn(t, t)));
    }
    case kRelu:
      return d > 0.0 ? 1.0f : 0.0f;
    case kSelu: {
      constexpr double kScaleAlpha = 1.0507009873554805 * 1.6732632423543772;
      return d > 0.0 ? static_cast<float>(1.0507009873554805)
                     : static_cast<float>(__dmul_rn(kScaleAlpha, exp(fmin(d, 0.0))));
    }
    default:
      return 1.0f;
  }
}

// The input dropout with the plain versions' rounding from keep byte `at`
// (read only with a dropout mode): alpha a * (keep ? x : alpha') + b,
// standard keep ? a * x : 0.
__device__ __forceinline__ float drop_rn(int mode, float a, float b, float x,
                                         const uint8_t* keep, size_t at) {
  if (mode == kNoDrop) return x;
  const bool k = keep[at] != 0;
  if (mode == kAlphaDrop) return __fadd_rn(__fmul_rn(a, k ? x : kAlphaP), b);
  return k ? __fmul_rn(a, x) : 0.0f;
}

// Its derivative applied to a cotangent x: x * (keep ? a : 0), x without
// dropout.
__device__ __forceinline__ float dmask_rn(int mode, float a, float x, const uint8_t* keep,
                                          size_t at) {
  return mode == kNoDrop ? x : __fmul_rn(x, keep[at] != 0 ? a : 0.0f);
}

// The shared-memory regions of a bf16 kernel's CTA: the adjacency [W][W]
// (adj[src * W + dst]), then rows [W][D] (s, h1 and, in the reverse, gs) and
// chunks [W][kBf16Chunk] (ua, c0 and, in the reverse, c1, c2).
struct Bf16Smem {
  uint16_t* adj;
  float* s;
  float* h1;
  float* gs;
  float* ua;
  float* c0;
  float* c1;
  float* c2;
};

// Bytes of the layout (fused2.bf16_smem_bytes): the forward's two rows and
// two chunks, the reverse's three and four.
inline size_t bf16_smem(int W, int D, bool reverse) {
  const size_t rows = reverse ? 3 : 2, chunks = reverse ? 4 : 2;
  return 2 * (size_t)W * W + 4 * (size_t)W * (rows * D + chunks * kBf16Chunk);
}

__device__ inline Bf16Smem bf16_layout(void* base, int W, int D, bool reverse) {
  Bf16Smem m;
  m.adj = static_cast<uint16_t*>(base);
  float* f = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  const int WD = W * D, WC = W * kBf16Chunk;
  m.s = f;
  m.h1 = f + WD;
  m.gs = reverse ? f + 2 * WD : nullptr;
  f += (reverse ? 3 : 2) * WD;
  m.ua = f;
  m.c0 = f + WC;
  m.c1 = reverse ? f + 2 * WC : nullptr;
  m.c2 = reverse ? f + 3 * WC : nullptr;
  return m;
}

// Stage block b's bf16 adjacency (16-byte copies: 2*W*W is a multiple of 16)
// and its rows [W][D] of `rows` into m.s.
__device__ inline void bf16_stage(const Bf16Smem& m, const uint16_t* __restrict__ adjT,
                                  const float* __restrict__ rows, int b, int W, int D) {
  const int4* src = reinterpret_cast<const int4*>(adjT + (size_t)b * W * W);
  int4* dst = reinterpret_cast<int4*>(m.adj);
  for (int i = threadIdx.x; i < W * W / 8; i += blockDim.x) dst[i] = src[i];
  const float* r = rows + (size_t)b * W * D;
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) m.s[i] = r[i];
}

// U's halves of the hidden chunk [h0, h0 + cw): U_s into c0, bf(U_a) into ua.
__device__ inline void bf16_u_chunk(const Bf16Smem& m, const float* __restrict__ w20, int W,
                                    int D, int H1, int h0, int cw) {
  for (int i = threadIdx.x; i < W * 2 * cw; i += blockDim.x) {
    const int n = i / (2 * cw), j = i % (2 * cw);
    const bool a = j >= cw;
    const int h = a ? j - cw : j;
    const float* w = w20 + (size_t)((a ? H1 : 0) + h0 + h) * D;
    const float* s = m.s + n * D;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(bf(s[d]), bf(__ldg(w + d)), acc);
    if (a) {
      m.ua[n * kBf16Chunk + h] = bf(acc);
    } else {
      m.c0[n * kBf16Chunk + h] = acc;
    }
  }
}

// h0 of the chunk: (U_s + A) + fT (+ rT), A over the sources ascending.
// Writes h0 into `h0_out` (may be c0, which holds U_s) unless null and, where
// y0_out is given, act0(h0) into it, rounded to bf16 when `round_y0`.
__device__ inline void bf16_h0_chunk(const Bf16Smem& m, const float* __restrict__ fT,
                                     const float* __restrict__ rT, int b, int W, int H1,
                                     int h0, int cw, int act0, float* h0_out, float* y0_out,
                                     bool round_y0) {
  for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
    const int dst = i / cw, h = i % cw;
    float acc = 0.0f;
    for (int src = 0; src < W; ++src)
      acc = fmaf(bf16_value(m.adj[src * W + dst]), m.ua[src * kBf16Chunk + h], acc);
    const size_t g = ((size_t)b * W + dst) * H1 + h0 + h;
    float v = __fadd_rn(__fadd_rn(m.c0[dst * kBf16Chunk + h], acc), __ldg(fT + g));
    if (rT != nullptr) v = __fadd_rn(v, __ldg(rT + g));
    if (h0_out != nullptr) h0_out[dst * kBf16Chunk + h] = v;
    if (y0_out != nullptr) {
      const float y = act64(act0, v);
      y0_out[dst * kBf16Chunk + h] = round_y0 ? bf(y) : y;
    }
  }
}

// h1 += the chunk's terms bf(y0) * bf(w1), the units ascending; y0 in `y0`
// (rounded already when `rounded`).
__device__ inline void bf16_h1_chunk(const Bf16Smem& m, const float* __restrict__ w1,
                                     const float* y0, bool rounded, int W, int D, int H1,
                                     int h0, int cw) {
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const float* w = w1 + (size_t)d * H1 + h0;
    const float* y = y0 + n * kBf16Chunk;
    float acc = m.h1[i];
    for (int h = 0; h < cw; ++h) acc = fmaf(rounded ? y[h] : bf(y[h]), bf(__ldg(w + h)), acc);
    m.h1[i] = acc;
  }
}

// One forward iteration from m.s: m.h1 = act1(h1) * scale + shift.
__device__ inline void bf16_iteration(const Bf16Smem& m, const float* __restrict__ fT,
                                      const float* __restrict__ rT,
                                      const float* __restrict__ w20,
                                      const float* __restrict__ w1,
                                      const float* __restrict__ b1,
                                      const float* __restrict__ aff, int b, int W, int D, int H1,
                                      int act0, int act1) {
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) m.h1[i] = 0.0f;
  for (int h0 = 0; h0 < H1; h0 += kBf16Chunk) {
    const int cw = min(kBf16Chunk, H1 - h0);
    __syncthreads();  // s and h1 ready; the last chunk's h1 terms read ua/c0
    bf16_u_chunk(m, w20, W, D, H1, h0, cw);
    __syncthreads();
    bf16_h0_chunk(m, fT, rT, b, W, H1, h0, cw, act0, nullptr, m.c0, true);
    __syncthreads();
    bf16_h1_chunk(m, w1, m.c0, true, W, D, H1, h0, cw);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int d = i % D;
    const float h = __fadd_rn(m.h1[i], __ldg(b1 + d));
    m.h1[i] = __fadd_rn(__fmul_rn(act64(act1, h), __ldg(aff + d)), __ldg(aff + D + d));
  }
  __syncthreads();
}

// ---- the BatchNorm kernels' block rows (bn_bf16.cu, bn2_bf16.cu,
// bn_typed_bf16.cu): one CTA a block row, x3 = [s | agg | feats] [W][C1]
// node-major in shared memory, C1 = 2D + F.

// Stage block row blockIdx.x's bf16 adjacency into adj [W][W]: row r < Bl
// reads adj_loop[r], the rest adj_dep[r - Bl], where they lie (16-byte
// copies).
__device__ inline void bn_stage_adj(uint16_t* adj, const uint16_t* __restrict__ adj_loop,
                                    const uint16_t* __restrict__ adj_dep, int Bl, int W) {
  const int r = blockIdx.x;
  const uint16_t* a =
      r < Bl ? adj_loop + (size_t)r * W * W : adj_dep + (size_t)(r - Bl) * W * W;
  const int4* src = reinterpret_cast<const int4*>(a);
  int4* dst = reinterpret_cast<int4*>(adj);
  for (int i = threadIdx.x; i < W * W / 8; i += blockDim.x) dst[i] = src[i];
}

// x3's feature slice of block row blockIdx.x, through the dropout.
__device__ inline void bn_stage_feats(float* x3, const float* __restrict__ feats,
                                      const uint8_t* __restrict__ keep, int W, int D, int F,
                                      int mode, float da, float db) {
  const int C1 = 2 * D + F;
  const size_t row = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) {
    const int n = i / F, f = i % F;
    x3[n * C1 + 2 * D + f] =
        drop_rn(mode, da, db, __ldg(feats + row * F + i), keep, (row + n) * C1 + 2 * D + f);
  }
}

// The movement flags of block row blockIdx.x, a thread a node, d ascending:
// marg = nm where ||s - s_old|| > thr * ||s_old||; s [W][D] in shared
// memory, old(n, d) s_old's entry.
template <typename Old>
__device__ inline void bn_margins(const float* s, Old old, const float* __restrict__ nm,
                                  float* __restrict__ marg, int W, int D, float thr) {
  const size_t row = (size_t)blockIdx.x * W;
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    float dist = 0.0f, norm = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float o = old(n, d);
      const float e = s[n * D + d] - o;
      dist += e * e;
      norm += o * o;
    }
    marg[row + n] = sqrtf(dist) > thr * sqrtf(norm) ? __ldg(nm + row + n) : 0.0f;
  }
}

// agg = adjT^T @ bf(s) (+ rT) over the sources ascending, into agg_out and
// x3's aggregated slice (through the dropout).
__device__ inline void bn_aggregate(const uint16_t* adj, const float* s, float* x3,
                                    const float* __restrict__ rT, float* __restrict__ agg_out,
                                    const uint8_t* __restrict__ keep, int W, int D, int C1,
                                    int mode, float da, float db) {
  const size_t row = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int dst = i / D, d = i % D;
    float acc = 0.0f;
    for (int src = 0; src < W; ++src)
      acc = fmaf(bf16_value(adj[src * W + dst]), bf(s[src * D + d]), acc);
    if (rT != nullptr) acc = __fadd_rn(acc, __ldg(rT + row * D + i));
    agg_out[row * D + i] = acc;
    x3[dst * C1 + D + d] = drop_rn(mode, da, db, acc, keep, (row + dst) * C1 + D + d);
  }
}

// bf([x3 | 1]) . bf(w) of one node: x its x3 row [C1], w a weight row
// [C1 + 1] ([Ws | Wa | Wf | b]), c ascending, the bias last.
__device__ __forceinline__ float bn_dense_row(const float* x, const float* __restrict__ w,
                                              int C1) {
  float acc = 0.0f;
  for (int c = 0; c < C1; ++c) acc = fmaf(bf(x[c]), bf(__ldg(w + c)), acc);
  return __fadd_rn(acc, bf(__ldg(w + C1)));
}

// The pre-activation's cotangent of node n, entry d, from the BatchNorm
// coefficients `bnv` [9][D] (ops/bn.py::BNV_ROWS) of its type:
// gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2).
__device__ __forceinline__ float bn_gy(const float* __restrict__ bnv, float ds_in, float gsel,
                                       float y_k, float flag, float nm, int D, int d) {
  const float gs = __fadd_rn(ds_in, __fmul_rn(flag, gsel));
  const float xk = __fmul_rn(__fsub_rn(y_k, __ldg(bnv + 2 * D + d)), __ldg(bnv + 3 * D + d));
  const float t = __fadd_rn(__ldg(bnv + 5 * D + d), __fmul_rn(xk, __ldg(bnv + 6 * D + d)));
  return __fsub_rn(__fmul_rn(__ldg(bnv + 4 * D + d), gs), __fmul_rn(nm, t));
}

// dx2 entry (n, c) of block row blockIdx.x through the dropout's
// derivative: the state slice (c < D) into ds [W][D], the aggregated one
// into dagg_out and bf(dagg) into dg [W][D].
__device__ __forceinline__ void bn_split_dx2(float v, int n, int c, float* ds, float* dg,
                                             float* __restrict__ dagg_out,
                                             const uint8_t* __restrict__ keep, int W, int D,
                                             int C1, int mode, float da) {
  const size_t row = (size_t)blockIdx.x * W;
  if (mode != kNoDrop) v = __fmul_rn(v, keep[(row + n) * C1 + c] != 0 ? da : 0.0f);
  if (c < D) {
    ds[n * D + c] = v;
  } else {
    dagg_out[row * D + n * D + c - D] = v;
    dg[n * D + c - D] = bf(v);
  }
}

// ds += adjT @ bf(dagg) over the destinations ascending (dg holding
// bf(dagg)), into ds and ds_out.
__device__ inline void bn_contract(const uint16_t* adj, const float* dg, float* ds,
                                   float* __restrict__ ds_out, int W, int D) {
  const size_t row = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int src = i / D, d = i % D;
    float acc = 0.0f;
    for (int dst = 0; dst < W; ++dst)
      acc = fmaf(bf16_value(adj[src * W + dst]), dg[dst * D + d], acc);
    const float v = __fadd_rn(ds[i], acc);
    ds[i] = v;
    ds_out[row * D + i] = v;
  }
}

// red [2][D] of block row blockIdx.x: (sum ds, sum ds * x_hat_prev) over
// the nodes in order, x_hat_prev = (y_prev - bnv[7]) * bnv[8].
__device__ inline void bn_reductions(const float* ds, const float* __restrict__ y_prev,
                                     const float* __restrict__ bnv, float* __restrict__ red,
                                     int W, int D) {
  const size_t row = (size_t)blockIdx.x * W;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int n = 0; n < W; ++n) {
      const float v = ds[n * D + d];
      const float xp = __fmul_rn(
          __fsub_rn(__ldg(y_prev + (row + n) * D + d), __ldg(bnv + 7 * D + d)),
          __ldg(bnv + 8 * D + d));
      s1 = __fadd_rn(s1, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, xp));
    }
    red[((size_t)blockIdx.x * 2) * D + d] = s1;
    red[((size_t)blockIdx.x * 2 + 1) * D + d] = s2;
  }
}

inline bool bn_bf16_ok(int R, int Bl, int W, int D, int F) {
  return R > 0 && Bl >= 0 && Bl <= R && block_ok(R, W) && D > 0 && F >= 0;
}

}  // namespace gnn
