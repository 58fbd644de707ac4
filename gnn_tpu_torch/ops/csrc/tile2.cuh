// Register-tiled block products of the two-layer state net for Hopper
// (sm_90a), in plain fp32 on the CUDA cores, shared by the forward loops K10
// and K12 (loop2.cu), the two-layer eval step K9 (fused2.cu), the two-layer
// BatchNorm iteration K14 (bn2_fwd.cu), the three reverse kernels K13
// (train_loop2_bwd.cu), K11 (eval_loop2_bwd.cu) and K15 (bn2_train.cu), and,
// for their staging and adjacency lists, the one-layer K1 (bn_fwd.cu), K2
// (bn_train.cu), K3 (eval_loop.cu) and K8 (train_loop_bwd.cu) and the typed
// K17 (bn_typed.cu).
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
// One reverse step of the two-layer net (reverse_pass1, reverse_pass2) is
// the same device code in K13, K11 and K15: pass 1 forms h0, y0 and h1 on the
// tiles; the kernel forms dh1 from h1; pass 2 forms dy0 = dh1 @ w1, dh0, the
// weight sums of each chunk as block products over the block's nodes, and
// dx3 += dh0 @ w0. The kernels differ only in how they form x3 and the output
// cotangent before pass 1, dh1 from h1, and what they do with dx3 afterwards.
//
// Unit-major tiles T[j][n] (y0, h0, dh0) are written by the eight threads of
// a quarter-warp at eight different unit rows and read by threads that differ
// in the node block; the node block of row j is swizzled by (j / UT) & 7
// (tile_at), so both are free of bank conflicts.
//
// The staging of weights and rows uses cp.async (device builds; a host build
// of the same source copies synchronously). Nothing here uses atomics or warp
// shuffles (build_row_lists takes warp votes): every sum runs in a fixed
// order, so a launch repeats bit for bit.
//
// Shared-memory plans (tile2_layout): a kernel takes the first plan of its
// list whose layout fits a CTA's 227 KB; ops/fused2.py::_tile2_plan mirrors
// the lists and the layout byte for byte. Each list holds the plan of the
// hidden-150 recipe first and ends with the leanest plan.
//
// The wide plan (kTile2Wide, index: the list's length) is taken only where
// no plan of the list fits, and takes every width: the [C][W]- and
// [D][W]-sized regions (x3, the cotangent rows, a row buffer) lie in a
// device-memory workspace slice of the block row (tile2_layout's `ws` floats,
// allocated by the wrapper), w0, b0, w1 and b1 are read from device memory
// through the caches (W0Dev, W1Src), and shared memory holds only the y0 and
// h0 tiles and the adjacency lists. The kernels instantiate it once, 64
// outputs wide (WIDE): h1 and dx3 go through the 64-wide register tiles an
// output chunk at a time, parked in the workspace between hidden chunks
// (h1_io, dx_io), so every output is the staged plans' chain and a forced
// wide plan gives their bits.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace gnn {

constexpr int kTileThreads = 256;

// ut: units a thread owns in a chunk (4, or 2 for the leanest plans);
// nbuf: Y tiles (2: K10, and K11's pass 1, double-buffer them, one barrier a
// chunk fewer);
// keep: a reverse kernel keeps the whole h0 block (h0 computed once a reverse
// step), else recomputes it in pass 2; dw: K13 and K11 sum their weight
// partials in shared memory and write them once a launch, else in device
// memory; pf: K13 and K11 prefetch the next reverse step's rows with cp.async;
// E: room of the compact adjacency lists (0: the adjacency is read from device
// memory); pad: S / 4 odd; w1g: w1 is read from device memory, not staged.
// K14 (kBnForward2) reads pf as: the block's keep bytes are staged.
struct Tile2Plan {
  int ut, nbuf, keep, dw, pf, E, pad, w1g;
};

constexpr Tile2Plan kLoop2Plans[] = {{4, 2, 0, 0, 0, 16, 1, 0}, {4, 1, 0, 0, 0, 0, 1, 1}};
// K12 (loop2.cu), K10's forward in training: the same layout (kForward2; its
// affine rows go unused).
constexpr Tile2Plan kTrainLoop2Plans[] = {{4, 2, 0, 0, 0, 16, 1, 0}, {4, 1, 0, 0, 0, 0, 1, 1}};
constexpr Tile2Plan kTrain2Plans[] = {{4, 1, 1, 1, 1, 16, 1, 0},
                                      {4, 1, 1, 1, 0, 16, 1, 0},
                                      {4, 1, 0, 0, 0, 16, 1, 0},
                                      {2, 1, 0, 0, 0, 0, 0, 1}};
// K11 (eval_loop2_bwd.cu) and K15 (bn2_train.cu). A K15 launch is one reverse
// step, so its plans neither prefetch nor keep partials across steps, and it
// recomputes h0 in pass 2: two CTAs an SM hide one CTA's staging behind the
// other's products (on an NVIDIA H100, 0.85 ms against 1.14 with h0 kept, one
// CTA an SM, at the hidden-150 recipe on the training batch; PERF.md §6).
constexpr Tile2Plan kLoop2BwdPlans[] = {{4, 2, 1, 1, 1, 16, 1, 0},
                                        {4, 1, 0, 0, 0, 16, 1, 0},
                                        {2, 1, 0, 0, 0, 0, 0, 1}};
constexpr Tile2Plan kBn2BwdPlans[] = {{4, 1, 0, 0, 0, 16, 1, 0}, {2, 1, 0, 0, 0, 0, 0, 1}};
// K14 (bn2_fwd.cu), one BatchNorm-training iteration on K10's forward
// products: its lists, its rows and keep bytes staged, two y0 tiles; the
// leanest stages no keep bytes, builds no lists and reads w1 from device
// memory, and fits every shape the per-node K14 took.
constexpr Tile2Plan kBn2FwdPlans[] = {{4, 2, 0, 0, 1, 16, 1, 0}, {4, 1, 0, 0, 0, 0, 0, 1}};
// K9 (fused2.cu), one two-layer eval iteration on K10's forward products: its
// lists, w1 staged, two y0 tiles; the leanest builds no lists, reads w1 from
// device memory and pads no hidden stride, and fits every shape the per-node
// K9 took.
constexpr Tile2Plan kStep2Plans[] = {{4, 2, 0, 0, 0, 16, 1, 0}, {4, 1, 0, 0, 0, 0, 0, 1}};
// The wide plan of every tiled kernel: one y0 tile, h0 recomputed, partials
// in device memory, lists, w1 in device memory (layout: tile2_layout(...,
// wide = true)).
constexpr Tile2Plan kTile2Wide = {4, 1, 0, 0, 0, 16, 0, 1};
// Outputs a 64-wide instantiation holds in registers (h1: 8 a thread; dx3:
// 24 a thread) of the wide plan's chunks.
constexpr int kWideOut = 64, kWideCols = 192;

// The layouts: K10's and K12's forward; the reverse step of K13 and K15;
// K11's, which also recomputes the aggregation (a second list set) and sums
// the affine's and the features' cotangents; K14's, the forward with the two
// BatchNorm affines, the node mask, a node-major row buffer and the keep
// bytes; K9's, the forward with a node-major row buffer.
enum Tile2Kind { kForward2 = 0, kReverse2 = 1, kReverse2Agg = 2, kBnForward2 = 3, kStep2 = 4 };

__host__ __device__ inline int hidden_stride(int H1, int ut, int pad) {
  int s = (H1 + ut - 1) / ut * ut;
  if (pad && (s / 4) % 2 == 0) s += 4;
  return s;
}

// Offsets in floats into the dynamic shared memory (bytes for the list
// counts and source indices, after the floats).
struct Tile2Layout {
  int S;
  int x3, dh1, yt, ht, w0, w1, b0, pf, lw, dw, b1, aff, nm, ab, kp;
  int hw, dx, sv, ws;  // the wide plan's workspace: h1 and dx3 chunks, K12's state; floats
  size_t cnt_b, idx_b, bytes;
};

// kForward2 (K10, K12): X [C][W], Y [nbuf][CH][W], w0T [C][S], w1 [D][S] (none
// with w1g), b0 [S], lists [E][W], b1 [D], aff [2][D]. kReverse2 (K13, K15):
// X, G [D][W] (g + gs, dh1, then gs), Y [CH][W], H [S or CH][W] (h0, then
// dh0), w0T, w1, b0, prefetched rows [(3D + AL) W], lists, the weight
// partials [H1][C + 1] + [D][H1] + [D], b1. kReverse2Agg (K11): as
// kReverse2 with prefetched rows [2D W], two list sets (columns, rows), the
// partials followed by daff [2][D] and dfeats [AL][W], and the affine's
// scale [D] after b1. kBnForward2 (K14): as kForward2 with the affines
// [4][D], then from a 16-byte boundary the node mask [W], a row buffer
// [W][D | 1] and, with pf, the keep bytes [W][C] (16-byte aligned, rounded
// up to 16 bytes). kStep2 (K9): as kForward2, then from a 16-byte boundary a
// row buffer [W][D | 1].
// The wide plan (wide, p = kTile2Wide): a block row's workspace slice of ws
// floats holds x3 [C][W], with a reverse step G [D][W] and dx3 [C][W], h1
// [D][W], with kForward2 K12's undropped state [D][W], with kBnForward2 and
// kStep2 the row buffer [W][D | 1] (rounded up to 16 bytes); shared memory
// the y0 tile [CH][W], with a reverse step the h0 / dh0 tile [CH][W], the
// lists, with kBnForward2 the node mask [W], then the list bytes.
__host__ __device__ inline Tile2Layout tile2_layout(int kind, int W, int D, int AL, int H1,
                                                    const Tile2Plan& p, bool wide = false) {
  Tile2Layout L{};
  const bool rev = kind == kReverse2 || kind == kReverse2Agg, agg = kind == kReverse2Agg;
  const int C = 2 * D + AL, CH = 8 * p.ut, nl = agg ? 2 : 1;
  L.S = hidden_stride(H1, p.ut, p.pad);
  int o = 0;
  if (wide) {
    L.w0 = L.w1 = L.b0 = L.pf = L.dw = L.b1 = L.aff = L.kp = -1;
    L.x3 = o;
    o += C * W;
    if (rev) {
      L.dh1 = o;
      o += D * W;
      L.dx = o;
      o += C * W;
    }
    L.hw = o;
    o += D * W;
    L.sv = o;
    o += kind == kForward2 ? D * W : 0;
    L.ab = o;
    o += kind == kBnForward2 || kind == kStep2 ? (W * (D | 1) + 3) & ~3 : 0;
    L.ws = o;
    o = 0;
    L.yt = o;
    o += CH * W;
    L.ht = o;
    o += rev ? CH * W : 0;
    L.lw = o;
    o += nl * p.E * W;
    L.nm = o;
    o += kind == kBnForward2 ? W : 0;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + (size_t)nl * W;
    L.bytes = L.idx_b + (size_t)nl * p.E * W;
    return L;
  }
  L.x3 = o;
  o += C * W;
  if (rev) {
    L.dh1 = o;
    o += D * W;
  }
  L.yt = o;
  o += p.nbuf * CH * W;
  if (rev) {
    L.ht = o;
    o += (p.keep ? L.S : CH) * W;
  }
  L.w0 = o;
  o += C * L.S;
  L.w1 = o;
  o += p.w1g ? 0 : D * L.S;
  L.b0 = o;
  o += L.S;
  if (rev && p.pf) {
    L.pf = o;
    o += (agg ? 2 * D : 3 * D + AL) * W;
  }
  L.lw = o;
  o += nl * p.E * W;
  if (rev && p.dw) {
    L.dw = o;
    o += H1 * (C + 1) + D * H1 + D + (agg ? 2 * D + AL * W : 0);
  }
  L.b1 = o;
  o += D;
  if (!rev || agg) {
    L.aff = o;
    o += agg ? D : kind == kBnForward2 ? 4 * D : 2 * D;
  }
  if (kind == kBnForward2) {
    o = (o + 3) & ~3;
    L.nm = o;
    o += W;
    L.ab = o;
    o += W * (D | 1);
    o = (o + 3) & ~3;
    L.kp = o;
    o += p.pf ? (W * C + 15) / 16 * 4 : 0;
  }
  if (kind == kStep2) {
    o = (o + 3) & ~3;
    L.ab = o;
    o += W * (D | 1);
  }
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + (p.E ? nl * W : 0);
  L.bytes = L.idx_b + (size_t)nl * p.E * W;
  return L;
}

// The first plan of `plans` that fits a CTA, else the wide plan (index N),
// or plan `force` (>= 0; N the wide plan) if it fits; false (bytes: the last
// plan tried) if none. The staged plans' register tiles hold D and AL up to
// 64 (width_class): wider shapes take the wide plan. *ws: the plan's
// workspace floats a block row (0 for a staged plan).
template <size_t N>
inline bool pick_plan(int kind, const Tile2Plan (&plans)[N], int W, int D, int AL, int H1,
                      Tile2Plan* p, size_t* bytes, int* index, int force = -1, int* ws = nullptr) {
  const bool staged = width_class(D > AL ? D : AL) != 0;
  *bytes = 0;
  for (size_t i = force >= 0 ? (size_t)force : 0; i <= N; ++i) {
    const bool wide = i == N;
    if (!wide && !staged) {
      if (force >= 0) break;
      continue;
    }
    const Tile2Plan plan = wide ? kTile2Wide : plans[i];
    const Tile2Layout L = tile2_layout(kind, W, D, AL, H1, plan, wide);
    *bytes = L.bytes;
    if (*bytes <= (size_t)kMaxSmemBytes) {
      *p = plan;
      *index = static_cast<int>(i);
      if (ws != nullptr) *ws = wide ? L.ws : 0;
      return true;
    }
    if (force >= 0) break;
  }
  *index = -1;
  return false;
}

// Smem bytes, plan index, resident CTAs an SM, registers a thread and local
// bytes a thread of a kernel with plans, launched with `threads` threads a
// CTA, into out[0..4].
template <typename Kernel>
int tile_kernel_info(Kernel kernel, size_t bytes, int index, int* out,
                     int threads = kTileThreads) {
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, bytes);
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

// w0T [C][S] = w0 [H1][C] transposed (rows of stride ldw0 in device memory),
// w1 [D][S] (unless w1s is null), b0 [S] (entries of stride ldb0, zero past
// H1: K15's bias-augmented w0_aug [H1][C + 1] holds b0 as its last column),
// b1 [D].
__device__ inline void stage_tile_weights(const float* __restrict__ w0, int ldw0,
                                          const float* __restrict__ b0, int ldb0,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ b1, int C, int D, int H1,
                                          int S, float* w0T, float* w1s, float* b0s, float* b1s) {
  // in w0's order, so a warp reads whole rows of it
  for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
    const int j = i / C, c = i % C;
    if (j < H1)
      cp_async4(w0T + c * S + j, w0 + (size_t)j * ldw0 + c);
    else
      w0T[c * S + j] = 0.0f;
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
      cp_async4(b0s + j, b0 + (size_t)j * ldb0);
    else
      b0s[j] = 0.0f;
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) cp_async4(b1s + d, b1 + d);
}

// Rows [W][F] (contiguous) -> X[c0 + f][n], transposed; DEV: X lies in
// device memory (the wide plans' workspace), copied by plain loads and stores.
template <bool DEV = false>
__device__ inline void stage_rowsT(const float* __restrict__ g, int W, int F, float* X, int c0) {
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) {
    if constexpr (DEV)
      X[(c0 + i % F) * W + i / F] = g[i];
    else
      cp_async4(X + (c0 + i % F) * W + i / F, g + i);
  }
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

// The row lists of the block adjacency adj [W][W] (device memory, rows
// 16-byte aligned) exactly as build_list(..., by_col = false) builds them,
// from coalesced reads: each warp takes rows in turn, eight in flight, lane l
// reading columns 4l .. 4l + 3 of a row as one 16-byte load (W / 4 lanes),
// and places its nonzero entries after those of the lanes before it, which
// a __ballot_sync vote a column counts. Every thread of the CTA must call it
// (whole warps); the lists are complete after the next __syncthreads.
__device__ inline void build_row_lists(const float* __restrict__ adj, int W, int E, float* w,
                                       uint8_t* idx, uint8_t* cnt) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const bool on = lane < W / 4;
  const unsigned below = (1u << lane) - 1u;
  constexpr int R = 8;
  for (int n0 = threadIdx.x >> 5; n0 < W; n0 += R * nw) {
    float a[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r * nw;
      float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
      if (on && n < W) v = reinterpret_cast<const float4*>(adj + (size_t)n * W)[lane];
      a[r][0] = v.x;
      a[r][1] = v.y;
      a[r][2] = v.z;
      a[r][3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r * nw;
      if (n < W) {  // the same for the whole warp
        int pos = 0, total = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned votes = __ballot_sync(0xffffffffu, a[r][u] != 0.0f);
          pos += __popc(votes & below);
          total += __popc(votes);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (a[r][u] != 0.0f) {
            if (pos < E) {
              w[pos * W + n] = a[r][u];
              idx[pos * W + n] = static_cast<uint8_t>(4 * lane + u);
            }
            ++pos;
          }
        }
        if (lane == 0) cnt[n] = static_cast<uint8_t>(total);  // W <= 128
      }
    }
  }
}

// The column lists of the block adjacency adj [W][W] (device memory, rows
// 16-byte aligned) exactly as build_list(..., by_col = true) builds them,
// from coalesced reads: warp w of the CTA's nw takes rows [w W / nw,
// (w + 1) W / nw), lane l columns 4l .. 4l + 3 of a row as one 16-byte load
// (W / 4 lanes), four rows in flight; a first pass counts each column's
// nonzeros in the warp's rows into part [nw][W] (bytes of shared memory that
// nothing else uses until the lists are complete), the second reads the rows
// again and places each entry after those of the warps before, so each list
// holds its column's entries in row order. Every thread of the CTA must call
// it (W % nw == 0, W / nw % 4 == 0); it synchronises, and the lists are
// complete after the next __syncthreads.
__device__ inline void build_col_lists(const float* __restrict__ adj, int W, int E, float* w,
                                       uint8_t* idx, uint8_t* cnt, uint8_t* part) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const bool on = lane < W / 4;
  const int per = W / nw, m0 = wp * per;
  auto rows4 = [&](int m, float (&a)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
      if (on) v = reinterpret_cast<const float4*>(adj + (size_t)(m + r) * W)[lane];
      a[r][0] = v.x;
      a[r][1] = v.y;
      a[r][2] = v.z;
      a[r][3] = v.w;
    }
  };
  int c[4] = {0, 0, 0, 0};
  for (int m = m0; m < m0 + per; m += 4) {
    float a[4][4];
    rows4(m, a);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) c[u] += a[r][u] != 0.0f;
  }
  if (on)
#pragma unroll
    for (int u = 0; u < 4; ++u) part[wp * W + 4 * lane + u] = static_cast<uint8_t>(c[u]);
  __syncthreads();
  if (!on) return;
  int pos[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int before = 0, total = 0;
    for (int g = 0; g < nw; ++g) {
      const int k = part[g * W + 4 * lane + u];
      before += g < wp ? k : 0;
      total += k;
    }
    pos[u] = before;
    if (wp == 0) cnt[4 * lane + u] = static_cast<uint8_t>(total);  // W <= 128
  }
  for (int m = m0; m < m0 + per; m += 4) {
    float a[4][4];
    rows4(m, a);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (a[r][u] != 0.0f) {
          const int n = 4 * lane + u;
          if (pos[u] < E) {
            w[pos[u] * W + n] = a[r][u];
            idx[pos[u] * W + n] = static_cast<uint8_t>(m + r);
          }
          ++pos[u];
        }
      }
  }
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

// w0 and b0 as the products read them: W0Smem, the staged w0T [C][S] and
// b0 [S] in shared memory (advanced to a first unit); W0Dev (the wide plans),
// w0 [H1] rows of stride ld and b0 entries of stride ldb in device memory from
// unit j on, read 4 bytes at a time through the caches and zero past H1 as
// the staged copies are. Either way the same values enter the same FMAs in
// the same order. col(c, r, w): w[u] = w0[unit r + u][c]; bias(b): b[u] =
// b0[unit u].
struct W0Smem {
  const float* w;
  const float* b;
  int S;
  template <int N>
  __device__ __forceinline__ void col(int c, int r, float (&o)[N]) const {
    ldv<N>(w + c * S + r, o);
  }
  template <int N>
  __device__ __forceinline__ void bias(float (&o)[N]) const {
    ldv<N>(b, o);
  }
};

struct W0Dev {
  const float* w0;
  const float* b0;
  int ld, ldb, H1, j;
  __device__ __forceinline__ W0Dev at(int j1) const { return W0Dev{w0, b0, ld, ldb, H1, j1}; }
  template <int N>
  __device__ __forceinline__ void col(int c, int r, float (&o)[N]) const {
#pragma unroll
    for (int u = 0; u < N; ++u)
      o[u] = j + r + u < H1 ? w0[(size_t)(j + r + u) * ld + c] : 0.0f;
  }
  template <int N>
  __device__ __forceinline__ void bias(float (&o)[N]) const {
#pragma unroll
    for (int u = 0; u < N; ++u) o[u] = j + u < H1 ? b0[(size_t)(j + u) * ldb] : 0.0f;
  }
};

// a[n][u] = b0[u] + sum_c X[c][4 ng + n] * w0T[c][u] for this thread's nodes
// and units (the reader at the thread's first unit).
template <int UT, typename R>
__device__ __forceinline__ void first_product(const float* X, int W, int C, const R& w0,
                                              int ng, float (&a)[4][UT]) {
  float bv[UT];
  w0.bias(bv);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < UT; ++u) a[n][u] = bv[u];
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    float x[4], w[UT];
    ldv<4>(X + c * W + 4 * ng, x);
    w0.col(c, 0, w);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < UT; ++u) a[n][u] = fmaf(x[n], w[u], a[n][u]);
  }
}

// The staged first_product: w0T, b0 in shared memory, advanced to the
// thread's first unit.
template <int UT>
__device__ __forceinline__ void first_product(const float* X, int W, int C, const float* w0T,
                                              int S, const float* b0, int ng, float (&a)[4][UT]) {
  first_product<UT>(X, W, C, W0Smem{w0T, b0, S}, ng, a);
}

// h0 for this thread's 4 nodes x 4 units as the per-node K14 and K9 formed
// it: three chains over x3's state, aggregation and arc-label rows, each
// from 0 in column order, added as (s + a) + (f + b0); w0T and b0 advanced
// to the thread's first unit (K14, K9).
template <typename R>
__device__ __forceinline__ void first_product3(const float* X, int W, int D, int C, const R& w0,
                                               int ng, float (&h)[4][4]) {
  float t[4][4];
  auto chain = [&](int c0, int c1, float (&a)[4][4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[n][u] = 0.0f;
#pragma unroll 2
    for (int c = c0; c < c1; ++c) {
      float x[4], w[4];
      ldv<4>(X + c * W + 4 * ng, x);
      w0.col(c, 0, w);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[n][u] = fmaf(w[u], x[n], a[n][u]);
    }
  };
  chain(0, D, h);
  chain(D, 2 * D, t);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) h[n][u] += t[n][u];
  chain(2 * D, C, t);
  float bv[4];
  w0.bias(bv);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) h[n][u] += t[n][u] + bv[u];
}

__device__ __forceinline__ void first_product3(const float* X, int W, int D, int C,
                                               const float* w0T, int S, const float* b0, int ng,
                                               float (&h)[4][4]) {
  first_product3(X, W, D, C, W0Smem{w0T, b0, S}, ng, h);
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
// < C (the reader at unit j0): dx3 += dh0 @ w0 over a chunk.
template <int UT, int CT, typename R>
__device__ __forceinline__ void dx_product(const float* H, int hr, int W, const R& w0, int jc,
                                           int C, int ng, int cg, float (&dx)[4][CT]) {
  for (int r = 0; r < jc; r += UT) {
    float v[4][UT];
    load_tile<UT>(H, hr + r, ng, W, v);
#pragma unroll
    for (int i = 0; i < CT; ++i) {
      const int c = cg + 8 * i;
      if (c < C) {
        float w[UT];
        w0.col(c, r, w);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < UT; ++u) dx[n][i] = fmaf(v[n][u], w[u], dx[n][i]);
      }
    }
  }
}

// ---- the wide plans' output chunks

// h[n][i] = b1[d], d = dg + 8 i (0 past D).
template <int DG>
__device__ __forceinline__ void h1_bias(float (&h)[4][DG], const float* b1, int dg, int D) {
#pragma unroll
  for (int i = 0; i < DG; ++i) {
    const int d = dg + 8 * i;
#pragma unroll
    for (int n = 0; n < 4; ++n) h[n][i] = d < D ? b1[d] : 0.0f;
  }
}

// Park (STORE) or fetch this thread's register tile v[n][i] of rows r = rg +
// 8 i < R of a [R][W] array T (the wide plans' h1 and dx3 in the workspace,
// each entry touched only by its owner thread).
template <bool STORE, int N>
__device__ __forceinline__ void tile_io(float (&v)[4][N], float* T, int W, int ng, int rg,
                                        int R) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = rg + 8 * i;
    if (r < R)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if constexpr (STORE)
          T[r * W + 4 * ng + n] = v[n][i];
        else
          v[n][i] = T[r * W + 4 * ng + n];
      }
  }
}

// ---- one reverse step of the two-layer net (K13, K11, K15)

// A reverse step's operands in shared memory (tile2_layout's regions) and
// widths: x3 X [C][W], the output cotangent G [D][W] (dh1 when pass 2 runs),
// the y0 tiles Y [nbuf][CH][W] (pass 2 uses the first), H (the h0 block
// [S][W] with keep, else a chunk's [CH][W]; dh0 in pass 2), the weights.
struct Tile2Rev {
  float* X;
  float* G;
  float* Y;
  float* H;
  const float* w0T;
  const float* b0s;
  const float* b1s;
  W1Src w1;
  int W, C, D, H1, S, keep, nbuf;
  // the wide plan: w0 in device memory, the h1 and dx3 chunks in the workspace
  W0Dev w0d;
  float* HW;
  float* DX;
};

// Where pass 2 sums a reverse step's weight partials: with sm, in shared
// memory [H1][C + 1] (db0 the last column), [D][H1], [D], each step adding;
// else in device memory dw0 [H1] rows of stride ld0, db0 [H1] entries of
// stride ldb0, dw1 [D][H1], db1 [D], written (add false) or added to. Each
// entry has one owner thread, or two fixed halves summed before and after a
// barrier.
struct Tile2Parts {
  float* sm;
  float* dw0;
  float* db0;
  float* dw1;
  float* db1;
  int ld0, ldb0;
  bool add;
};

// Pass 1: h0 = x3 @ w0^T + b0 on this thread's register tiles (kept in H
// with keep), y0 = act0(h0) through Y a chunk at a time (two tiles in turn
// with nbuf 2, one barrier a chunk fewer), and h1 = y0 @ w1^T + b1 for nodes
// 4 ng + n and outputs d = jg + 8 i into h1[n][i]. Every thread must call it;
// it synchronises, and ends past the last chunk's first barrier (X and H, and
// with nbuf 1 also Y, are no longer read).
// WIDE (the wide plan): h1 for every output, 8 * DG at a time, ends in s.HW
// [D][W] (h1 holds the last chunk's).
template <int UT, int DG, bool WIDE = false>
__device__ __forceinline__ void reverse_pass1(const Tile2Rev& s, int act0, int ng, int jg,
                                              float (&h1)[4][DG]) {
  constexpr int CH = 8 * UT;
  const bool node_ok = 4 * ng < s.W;
  if constexpr (!WIDE) h1_bias<DG>(h1, s.b1s, jg, s.D);
  const int nch = (s.S + CH - 1) / CH;
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * CH, jc = min(CH, s.S - j0);
    float* Yb = s.Y + (s.nbuf == 2 ? (ci & 1) : 0) * CH * s.W;
    if (node_ok && UT * jg < jc) {
      float a[4][UT];
      if constexpr (WIDE)
        first_product<UT>(s.X, s.W, s.C, s.w0d.at(j0 + UT * jg), ng, a);
      else
        first_product<UT>(s.X, s.W, s.C, s.w0T + j0 + UT * jg, s.S, s.b0s + j0 + UT * jg, ng,
                          a);
      if (s.keep) store_tile<UT>(s.H, j0 + UT * jg, ng, s.W, a);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < UT; ++u) a[n][u] = activate(act0, a[n][u]);
      store_tile<UT>(Yb, UT * jg, ng, s.W, a);
    }
    __syncthreads();  // the chunk's y0 tile is full
    if constexpr (WIDE) {
      for (int d0 = 0; node_ok && d0 < s.D; d0 += 8 * DG) {
        if (ci == 0)
          h1_bias<DG>(h1, s.b1s, d0 + jg, s.D);
        else
          tile_io<false>(h1, s.HW, s.W, ng, d0 + jg, s.D);
        second_product<UT, DG>(Yb, s.W, s.w1, j0, jc, ng, d0 + jg, s.D, h1);
        tile_io<true>(h1, s.HW, s.W, ng, d0 + jg, s.D);
      }
    } else if (node_ok) {
      second_product<UT, DG>(Yb, s.W, s.w1, j0, jc, ng, jg, s.D, h1);
    }
    if (s.nbuf == 1) __syncthreads();  // the tile is rewritten by the next chunk
  }
}

// Pass 2, once G holds every node's dh1, a chunk at a time: dy0 = dh1 @ w1
// and dh0 = dy0 * act0'(h0) on the tiles (h0 read back, or formed again
// without keep; y0 = act0(h0) beside it), the chunk's weight sums as block
// products over the block's nodes, each thread owning 4 units x 4 columns of
// [x3 | 1] or of dh1 (dw0, db0 through a column of ones, dw1), 8 16-byte
// reads a 64 FMAs, two threads a quad (half of the nodes each) where that
// fits; and dx3 += dh0 @ w0 on 4-node x C/8-column register tiles, dx[n][i]
// for column jg + 8 i. db1, the sum of dh1 over the block's nodes in node
// order, is taken by the last D threads in the first chunk's weight-sum
// phase, which leaves them idle at the recipe's widths (a thread of warp 0
// taking it before the first chunk held every warp at that chunk's barrier).
// Every thread must call it; it synchronises and ends past the last chunk's
// barrier, with X, G, Y and H free.
// WIDE (the wide plan): dx3 for every column, 8 * CT at a time, ends in s.DX
// [C][W] (dx holds the last chunk's).
template <int UT, int CT, bool WIDE = false>
__device__ __forceinline__ void reverse_pass2(const Tile2Rev& s, const Tile2Parts& parts,
                                              int act0, int ng, int jg, float (&dx)[4][CT]) {
  constexpr int CH = 8 * UT;
  const int t = threadIdx.x, W = s.W, C = s.C, D = s.D, H1 = s.H1, S = s.S;
  const bool node_ok = 4 * ng < W;
  const bool sm = parts.sm != nullptr;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < CT; ++i) dx[n][i] = 0.0f;
  const int nch = (S + CH - 1) / CH;
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * CH, jc = min(CH, S - j0), hr = s.keep ? j0 : 0;
    if (node_ok && UT * jg < jc) {
      const int j = j0 + UT * jg;
      float dy[4][UT], h[4][UT];
      dy_product<UT>(s.G, W, D, s.w1, j, ng, dy);
      if constexpr (WIDE)
        first_product<UT>(s.X, W, C, s.w0d.at(j), ng, h);
      else if (s.keep)
        load_tile<UT>(s.H, hr + UT * jg, ng, W, h);
      else
        first_product<UT>(s.X, W, C, s.w0T + j, S, s.b0s + j, ng, h);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          float y, g;
          act_and_grad(act0, h[n][u], y, g);
          dy[n][u] *= g;
          h[n][u] = y;
        }
      store_tile<UT>(s.Y, UT * jg, ng, W, h);         // y0
      store_tile<UT>(s.H, hr + UT * jg, ng, W, dy);   // dh0
    }
    __syncthreads();  // the chunk's y0 and dh0 tiles are full
    auto sum_db1 = [&](int d) {
      float acc = 0.0f;
      for (int n = 0; n < W; ++n) acc += s.G[d * W + n];
      float* dst = sm ? parts.sm + H1 * (C + 1) + D * H1 + d : parts.db1 + d;
      *dst = sm || parts.add ? *dst + acc : acc;
    };
    if constexpr (WIDE) {   // every thread takes D / 256 of them past 256
      for (int d = t - (kTileThreads - D); ci == 0 && d >= 0; d -= kTileThreads) sum_db1(d);
    } else if (ci == 0 && t >= kTileThreads - D) {
      sum_db1(t - (kTileThreads - D));
    }
    // weight sums of the chunk's units j < H1 as block products over the
    // block's nodes: thread (4 units, 4 columns of [x3 | 1] or of dh1) for
    // dw0 [j][q], db0 [j] (q = C, the column of ones) and dw1 [d][j]. With
    // at most 16 column quads two threads share a quad, each summing half of
    // the nodes: the first adds its sum at once, the second after the
    // chunk's last barrier, so every entry is summed in a fixed order.
    const int jr = min(CH, H1 - j0), r0 = UT * jg;
    const int nq0 = (C + 4) / 4, nq = nq0 + (D + 3) / 4;
    const bool split = nq <= 16;
    const int half = split ? ng & 1 : 0;
    auto partial = [&](int qq, int u, int i) -> float* {  // entry (unit r0 + u, column i of quad qq)
      const int j = j0 + r0 + u;
      if (qq >= nq0) {
        const int d = 4 * (qq - nq0) + i;
        return sm ? parts.sm + H1 * (C + 1) + d * H1 + j : parts.dw1 + (size_t)d * H1 + j;
      }
      const int q = 4 * qq + i;
      if (sm) return parts.sm + j * (C + 1) + q;
      return q < C ? parts.dw0 + (size_t)j * parts.ld0 + q : parts.db0 + (size_t)j * parts.ldb0;
    };
    auto ncols = [&](int qq) { return qq >= nq0 ? min(4, D - 4 * (qq - nq0)) : min(4, C + 1 - 4 * qq); };
    float acc[UT][4];
    int pending = -1;  // the quad whose second-half sum waits for the barrier
    if (r0 < jr)
      for (int qq = split ? ng >> 1 : ng; qq < nq; qq += split ? 16 : 32) {
        const bool w1part = qq >= nq0;
        const int q0 = 4 * (w1part ? qq - nq0 : qq), ncol = w1part ? D : C + 1;
        const float* uni = w1part ? s.Y : s.H;
        const int ur = (w1part ? 0 : hr) + r0;
        const float* cols[4];  // null: the column of ones, or past the last column
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i;
          cols[i] = q >= ncol || (!w1part && q == C) ? nullptr : (w1part ? s.G : s.X) + q * W;
        }
#pragma unroll
        for (int u = 0; u < UT; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[u][i] = 0.0f;
        const int bb0 = half * (W / 8), bb1 = split ? bb0 + W / 8 : W / 4;
        for (int bb = bb0; bb < bb1; ++bb) {
          float v[UT][4];
#pragma unroll
          for (int u = 0; u < UT; ++u) ldv<4>(uni + tile_at<UT>(ur + u, bb, W), v[u]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x[4] = {1.0f, 1.0f, 1.0f, 1.0f};
            if (cols[i] != nullptr) ldv<4>(cols[i] + 4 * bb, x);
#pragma unroll
            for (int u = 0; u < UT; ++u)
#pragma unroll
              for (int n = 0; n < 4; ++n) acc[u][i] = fmaf(v[u][n], x[n], acc[u][i]);
          }
        }
        if (half == 1) {
          pending = qq;
          continue;
        }
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          if (r0 + u >= jr) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i >= ncols(qq)) break;
            float* dst = partial(qq, u, i);
            *dst = sm || parts.add ? *dst + acc[u][i] : acc[u][i];
          }
        }
      }
    // dx3 += dh0 @ w0 over the chunk
    if constexpr (WIDE) {
      for (int c0 = 0; node_ok && c0 < C; c0 += 8 * CT) {
        if (ci == 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < CT; ++i) dx[n][i] = 0.0f;
        } else {
          tile_io<false>(dx, s.DX, W, ng, c0 + jg, C);
        }
        dx_product<UT, CT>(s.H, hr, W, s.w0d.at(j0), jc, C, ng, c0 + jg, dx);
        tile_io<true>(dx, s.DX, W, ng, c0 + jg, C);
      }
    } else if (node_ok) {
      dx_product<UT, CT>(s.H, hr, W, W0Smem{s.w0T + j0, nullptr, S}, jc, C, ng, jg, dx);
    }
    __syncthreads();  // the tiles are rewritten by the next chunk; first halves are in
    if (pending >= 0)
#pragma unroll
      for (int u = 0; u < UT; ++u) {
        if (r0 + u >= jr) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= ncols(pending)) break;
          float* dst = partial(pending, u, i);
          *dst += acc[u][i];
        }
      }
  }
}

}  // namespace gnn
