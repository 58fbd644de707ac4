// Device code shared by the bf16-adjacency variants of the two-layer eval
// kernels (loop2_bf16.cu: K10_bf16, fused2_bf16.cu: K9_bf16,
// eval_loop2_bwd_bf16.cu: K11_bf16), gnn_tpu's `hp = False` branch
// (pallas_fused.py:104-217, :1127-1169, :1390-1470); its rounding, the
// activations and the dropout also serve eval_loop_bf16.cu (K3_bf16,
// K4_bf16), eval_loop_bwd_bf16.cu (K5_bf16), bn_bf16.cu (K1_bf16, K2_bf16)
// and train_loop2_bf16.cu (K12_bf16, K13_bf16).
//
// Write bf(x) for x rounded to bf16 to nearest even and used as f32. One
// iteration on a block of W nodes, node-major, w20 = [W0s; W0a] [2H1, D]:
//   U  = bf(s) @ bf(w20)^T                  [W, 2H1]
//   A  = adjT^T @ bf(U_a)                   adjT [W(src), W(dst)] in bf16
//   h0 = (U_s + A) + fT (+ rT)              fT, rT f32 [W, H1]
//   h1 = bf(act0(h0)) @ bf(w1)^T + b1       w1 [D, H1]
//   s' = act1(h1) * scale + shift
// Every product is of two bf values, so exact in f32, and each sum runs over
// its contracted index ascending (A over the sources, h1 over the hidden
// units chunk by chunk), one f32 add a term: the order of the plain versions
// (ops/fused2.py), so a kernel gives their bits. The activations are
// evaluated in float64 and rounded to f32 once (fused2.act64): the card and
// the CPU then take the same bf16 rounding of y0.
//
// Design (simple, not yet tuned): one CTA of 256 threads a block. The bf16
// adjacency is staged in shared memory once (2*W*W bytes, 32 KiB at
// W = 128), beside the state and h1 rows [W][D]; the hidden units run in
// chunks of kBf16Chunk = 32: U's two halves of the chunk, then A and y0,
// then the chunk's terms of h1. Weights are read through the read-only
// cache. No atomics: a repeat launch is bit-identical.

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

}  // namespace gnn
