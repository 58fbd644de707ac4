// Register-tiled block products of the two-layer state net for Hopper
// (sm_90a), in plain fp32 on the CUDA cores, shared by the redesigned K10
// (loop2.cu) and K13 (train_loop2_bwd.cu).
//
// A CTA of kTileThreads = 256 threads works on one W-node block. Its dense
// input x3 = [s | agg | f] lies in shared memory transposed, X[c][n] (C rows
// of W nodes), so four neighbouring nodes are one 16-byte read. The hidden
// layer is formed in chunks of CH = 8 * UT hidden units: thread t owns the
// register tile of nodes 4 * (t / 8) .. + 3 and units UT * (t % 8) .. + UT - 1
// of the chunk, and every shared-memory read of an operand is a float4 (four
// nodes) or a float4/float2 (UT units), so one read feeds 4 * UT or more FMAs:
//   h0 tile   = b0 + sum_c X[c][nodes] (x) w0T[c][units]         first_product
//   y0 tile   -> Y[unit][node] (swizzled, below)                  store_tile
//   h1[n][d] += sum_j Y[j][n] * w1[d][j]  (d = t % 8 + 8 i)       second_product
// so an [W, H1] hidden block is never held whole. The weights sit in shared
// memory as w0T [C][S] (transposed) and w1 [D][S], S the hidden width padded
// to a multiple of UT (and, where it fits, to S / 4 odd, so the eight rows a
// warp reads at once lie in eight different 16-byte bank groups); padded
// units have zero weights and biases and add exactly 0. The leanest plans
// leave w1 in device memory (W1Src), so that they fit every shape the
// per-node kernels these replace took.
//
// Unit-major tiles T[j][n] (y0, h0, dh0) are written by the eight threads of
// a quarter-warp at eight different unit rows and read by threads that differ
// in the node block; the node block of row j is swizzled by (j / UT) & 7
// (tile_at), so both are free of bank conflicts.
//
// The staging of weights and rows uses cp.async (device builds; a host build
// of the same source copies synchronously). Nothing here uses atomics or warp
// shuffles: every sum runs in a fixed order, so a launch repeats bit for bit.
//
// Shared-memory plans (tile2_layout): a kernel takes the first plan of its
// list whose layout fits a CTA's 227 KB; ops/fused2.py::_tile2_plan mirrors
// the lists and the layout byte for byte. Each list holds the plan of the
// hidden-150 recipe first and ends with the leanest plan.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace gnn {

constexpr int kTileThreads = 256;

// ut: units a thread owns in a chunk (4, or 2 for K13's leanest plan);
// nbuf: Y tiles (2: K10 double-buffers them, one barrier a chunk fewer);
// keep: K13 keeps the whole h0 block (h0 computed once a reverse step), else
// recomputes it in the reverse pass; dw: K13 sums its weight partials in
// shared memory and writes them once a launch, else in device memory;
// pf: K13 prefetches the next reverse step's rows with cp.async;
// E: room of the compact adjacency lists (0: the adjacency is read from device
// memory); pad: S / 4 odd; w1g: w1 is read from device memory, not staged.
struct Tile2Plan {
  int ut, nbuf, keep, dw, pf, E, pad, w1g;
};

constexpr Tile2Plan kLoop2Plans[] = {{4, 2, 0, 0, 0, 16, 1, 0}, {4, 1, 0, 0, 0, 0, 1, 1}};
constexpr Tile2Plan kTrain2Plans[] = {{4, 1, 1, 1, 1, 16, 1, 0},
                                      {4, 1, 1, 1, 0, 16, 1, 0},
                                      {4, 1, 0, 0, 0, 16, 1, 0},
                                      {2, 1, 0, 0, 0, 0, 0, 1}};

__host__ __device__ inline int hidden_stride(int H1, int ut, int pad) {
  int s = (H1 + ut - 1) / ut * ut;
  if (pad && (s / 4) % 2 == 0) s += 4;
  return s;
}

// Offsets in floats into the dynamic shared memory (bytes for the list
// counts and source indices, after the floats).
struct Tile2Layout {
  int S;
  int x3, dh1, yt, ht, w0, w1, b0, pf, lw, dw, b1, aff;
  size_t cnt_b, idx_b, bytes;
};

// K10 (train false): X [C][W], Y [nbuf][CH][W], w0T [C][S], w1 [D][S] (none
// with w1g), b0 [S],
// lists [E][W], b1 [D], aff [2][D]. K13 (train true): X, G [D][W] (g + gs,
// dh1, then gs), Y [CH][W], H [S or CH][W] (h0, then dh0), w0T, w1, b0,
// prefetched rows [(3D + AL) W], lists, the weight partials
// [H1][C + 1] + [D][H1] + [D], b1.
__host__ __device__ inline Tile2Layout tile2_layout(bool train, int W, int D, int AL, int H1,
                                                    const Tile2Plan& p) {
  Tile2Layout L{};
  const int C = 2 * D + AL, CH = 8 * p.ut;
  L.S = hidden_stride(H1, p.ut, p.pad);
  int o = 0;
  L.x3 = o;
  o += C * W;
  if (train) {
    L.dh1 = o;
    o += D * W;
  }
  L.yt = o;
  o += p.nbuf * CH * W;
  if (train) {
    L.ht = o;
    o += (p.keep ? L.S : CH) * W;
  }
  L.w0 = o;
  o += C * L.S;
  L.w1 = o;
  o += p.w1g ? 0 : D * L.S;
  L.b0 = o;
  o += L.S;
  if (train && p.pf) {
    L.pf = o;
    o += (3 * D + AL) * W;
  }
  L.lw = o;
  o += p.E * W;
  if (train && p.dw) {
    L.dw = o;
    o += H1 * (C + 1) + D * H1 + D;
  }
  L.b1 = o;
  o += D;
  if (!train) {
    L.aff = o;
    o += 2 * D;
  }
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + (p.E ? W : 0);
  L.bytes = L.idx_b + (size_t)p.E * W;
  return L;
}

// The first plan of `plans` that fits a CTA; false (bytes: the last plan's) if none.
template <size_t N>
inline bool pick_plan(bool train, const Tile2Plan (&plans)[N], int W, int D, int AL, int H1,
                      Tile2Plan* p, size_t* bytes, int* index) {
  for (size_t i = 0; i < N; ++i) {
    *bytes = tile2_layout(train, W, D, AL, H1, plans[i]).bytes;
    if (*bytes <= (size_t)kMaxSmemBytes) {
      *p = plans[i];
      *index = static_cast<int>(i);
      return true;
    }
  }
  *index = -1;
  return false;
}

// Smem bytes, plan index, resident CTAs an SM, registers a thread and local
// bytes a thread of a tiled kernel, into out[0..4].
template <typename Kernel>
int tile_kernel_info(Kernel kernel, size_t bytes, int index, int* out) {
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kTileThreads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = index;
  out[1] = static_cast<int>(bytes);
  out[2] = ctas;
  out[3] = a.numRegs;
  out[4] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

// ---- asynchronous copies (a host build of the source copies at once)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

// Wait for this thread's copies; a __syncthreads must follow before other
// threads read them.
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// n contiguous floats (n % 4 == 0; both ends 16-byte aligned: the wrappers
// check the tensors' alignment, and a block's rows start at multiples of
// 32 * 4 bytes) by 16-byte copies.
__device__ inline void cp_rows(float* dst, const float* __restrict__ src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
}

// ---- vector reads and writes of shared memory

template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&o)[N]) {
  static_assert(N == 4 || N == 2, "float4 or float2");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  }
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  float4 v;
  v.x = a;
  v.y = b;
  v.z = c;
  v.w = d;
  *reinterpret_cast<float4*>(p) = v;
}

// Float offset of the four nodes of block blk in row r of a unit-major tile.
template <int UT>
__device__ __forceinline__ int tile_at(int r, int blk, int W) {
  return r * W + 4 * (blk ^ ((r / UT) & 7));
}

// ---- staging

// w0T [C][S] = w0 [H1][C] transposed, w1 [D][S] (unless w1s is null), b0 [S]
// (zero past H1), b1 [D].
__device__ inline void stage_tile_weights(const float* __restrict__ w0,
                                          const float* __restrict__ b0,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ b1, int C, int D, int H1,
                                          int S, float* w0T, float* w1s, float* b0s, float* b1s) {
  for (int i = threadIdx.x; i < C * S; i += blockDim.x) {
    const int c = i / S, j = i % S;
    if (j < H1)
      cp_async4(w0T + i, w0 + (size_t)j * C + c);
    else
      w0T[i] = 0.0f;
  }
  for (int i = threadIdx.x; w1s != nullptr && i < D * S; i += blockDim.x) {
    const int d = i / S, j = i % S;
    if (j < H1)
      cp_async4(w1s + i, w1 + (size_t)d * H1 + j);
    else
      w1s[i] = 0.0f;
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    if (j < H1)
      cp_async4(b0s + j, b0 + j);
    else
      b0s[j] = 0.0f;
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) cp_async4(b1s + d, b1 + d);
}

// Rows [W][F] (contiguous) -> X[c0 + f][n], transposed.
__device__ inline void stage_rowsT(const float* __restrict__ g, int W, int F, float* X, int c0) {
  for (int i = threadIdx.x; i < W * F; i += blockDim.x)
    cp_async4(X + (c0 + i % F) * W + i / F, g + i);
}

// The nonzero entries of line `n` of the block adjacency adj [W][W] (device
// memory), in order: entry e of line n at w[e * W + n], its other index at
// idx[e * W + n], at most E of them; cnt[n] = the line's nonzero count (a
// line with more than E is read from device memory). `by_col`: line n is
// column n (the sources of destination n), else row n.
// The line is read 16 entries at a time, all loads issued before any is
// tested, so a thread waits for device memory W / 16 times, not W times.
__device__ inline void build_list(const float* __restrict__ adj, int W, int n, int E, bool by_col,
                                  float* w, uint8_t* idx, uint8_t* cnt) {
  int c = 0;
  for (int m0 = 0; m0 < W; m0 += 16) {  // W % 32 == 0
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      a[u] = by_col ? adj[(size_t)(m0 + u) * W + n] : adj[(size_t)n * W + m0 + u];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (a[u] != 0.0f) {
        if (c < E) {
          w[c * W + n] = a[u];
          idx[c * W + n] = static_cast<uint8_t>(m0 + u);
        }
        ++c;
      }
    }
  }
  cnt[n] = static_cast<uint8_t>(c);  // W <= 128
}

// sum over line n of adj(n, m) * xs[m]: from the list when it holds the
// line, else from device memory (every entry, zeros too).
__device__ __forceinline__ float line_dot(const float* __restrict__ adj, int W, int n, bool by_col,
                                          int E, const float* w, const uint8_t* idx,
                                          const uint8_t* cnt, const float* xs) {
  float acc = 0.0f;
  const int c = E > 0 ? cnt[n] : W + 1;
  if (c <= E) {
    for (int e = 0; e < c; ++e) acc = fmaf(w[e * W + n], xs[idx[e * W + n]], acc);
  } else {
    for (int m = 0; m < W; ++m)
      acc = fmaf(by_col ? adj[(size_t)m * W + n] : adj[(size_t)n * W + m], xs[m], acc);
  }
  return acc;
}

// activate(act, x) and act_grad(act, x) at once, bit for bit as common.cuh
// forms them, with selu's exponential and tanh taken once.
__device__ __forceinline__ void act_and_grad(int act, float x, float& y, float& g) {
  if (act == kSelu) {
    const float e = expf(fminf(x, 0.0f));
    y = 1.0507009873554805f * (x > 0.0f ? x : 1.6732632423543772f * (e - 1.0f));
    g = x > 0.0f ? 1.0507009873554805f : 1.0507009873554805f * 1.6732632423543772f * e;
  } else if (act == kTanh) {
    const float th = tanhf(x);
    y = th;
    g = 1.0f - th * th;
  } else {
    y = activate(act, x);
    g = act_grad(act, x);
  }
}

// ---- the block products

// w1 as the products read it: the staged copy ws [D][S] in shared memory,
// or, with plan w1g (dev), w1 [D][H1] itself in device memory, read 4 bytes
// at a time and zero past H1 as the staged copy is. Either way the same
// values enter the same FMAs in the same order.
struct W1Src {
  const float* ws;
  const float* w1;
  int S, H1;
  bool dev;
};

// w[u] = w1[d][j + u], u < UT.
template <int UT>
__device__ __forceinline__ void load_w1(const W1Src& src, int d, int j, float (&w)[UT]) {
  if (!src.dev) {
    ldv<UT>(src.ws + d * src.S + j, w);
    return;
  }
#pragma unroll
  for (int u = 0; u < UT; ++u) w[u] = j + u < src.H1 ? src.w1[(size_t)d * src.H1 + j + u] : 0.0f;
}

// a[n][u] = b0[u] + sum_c X[c][4 ng + n] * w0T[c][u] for this thread's nodes
// and units (w0T, b0 advanced to the thread's first unit).
template <int UT>
__device__ __forceinline__ void first_product(const float* X, int W, int C, const float* w0T,
                                              int S, const float* b0, int ng, float (&a)[4][UT]) {
  float bv[UT];
  ldv<UT>(b0, bv);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < UT; ++u) a[n][u] = bv[u];
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    float x[4], w[UT];
    ldv<4>(X + c * W + 4 * ng, x);
    ldv<UT>(w0T + c * S, w);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < UT; ++u) a[n][u] = fmaf(x[n], w[u], a[n][u]);
  }
}

// T[r0 + u][nodes of block ng] = v[.][u].
template <int UT>
__device__ __forceinline__ void store_tile(float* T, int r0, int ng, int W,
                                           const float (&v)[4][UT]) {
#pragma unroll
  for (int u = 0; u < UT; ++u)
    st4(T + tile_at<UT>(r0 + u, ng, W), v[0][u], v[1][u], v[2][u], v[3][u]);
}

template <int UT>
__device__ __forceinline__ void load_tile(const float* T, int r0, int ng, int W,
                                          float (&v)[4][UT]) {
#pragma unroll
  for (int u = 0; u < UT; ++u) {
    float x[4];
    ldv<4>(T + tile_at<UT>(r0 + u, ng, W), x);
#pragma unroll
    for (int n = 0; n < 4; ++n) v[n][u] = x[n];
  }
}

// h[n][i] += sum_{r < jc} Y[r][4 ng + n] * w1[d][j0 + r], d = dg + 8 i < D,
// the units in order.
template <int UT, int DG>
__device__ __forceinline__ void second_product(const float* Y, int W, const W1Src& w1, int j0,
                                               int jc, int ng, int dg, int D,
                                               float (&h)[4][DG]) {
  for (int r = 0; r < jc; r += UT) {
    float y[4][UT];
    load_tile<UT>(Y, r, ng, W, y);
#pragma unroll
    for (int i = 0; i < DG; ++i) {
      const int d = dg + 8 * i;
      if (d < D) {
        float w[UT];
        load_w1<UT>(w1, d, j0 + r, w);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < UT; ++u) h[n][i] = fmaf(y[n][u], w[u], h[n][i]);
      }
    }
  }
}

// dy[n][u] = sum_d G[d][4 ng + n] * w1[d][j + u] (j the thread's first
// unit): dy0 = dh1 @ w1 on this thread's tile.
template <int UT>
__device__ __forceinline__ void dy_product(const float* G, int W, int D, const W1Src& w1, int j,
                                           int ng, float (&dy)[4][UT]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < UT; ++u) dy[n][u] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float g[4], w[UT];
    ldv<4>(G + d * W + 4 * ng, g);
    load_w1<UT>(w1, d, j, w);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < UT; ++u) dy[n][u] = fmaf(g[n], w[u], dy[n][u]);
  }
}

// dx[n][i] += sum_{r < jc} H[hr + r][4 ng + n] * w0T[c][j0 + r], c = cg + 8 i
// < C (w0T advanced to column j0): dx3 += dh0 @ w0 over a chunk.
template <int UT, int CT>
__device__ __forceinline__ void dx_product(const float* H, int hr, int W, const float* w0T, int S,
                                           int jc, int C, int ng, int cg, float (&dx)[4][CT]) {
  for (int r = 0; r < jc; r += UT) {
    float v[4][UT];
    load_tile<UT>(H, hr + r, ng, W, v);
#pragma unroll
    for (int i = 0; i < CT; ++i) {
      const int c = cg + 8 * i;
      if (c < C) {
        float w[UT];
        ldv<UT>(w0T + c * S + r, w);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < UT; ++u) dx[n][i] = fmaf(v[n][u], w[u], dx[n][i]);
      }
    }
  }
}

}  // namespace gnn
