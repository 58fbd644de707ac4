// K1, one BatchNorm-training iteration of a one-layer state net, for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K1 _bn_fwd_kernel (launched by _bn_fwd_call) -> gnn_bn_forward
// Its reverse, K2, is in bn_train.cu.
//
// A trailing BatchNorm couples every block each iteration through the batch
// moments, so one launch runs one iteration over every block row, and
// [D]-sized glue (ops/bn.py) runs between launches. One iteration on one
// W-node block, x3 = [s | agg | feats] the dense input of C1 = 2D + F
// columns, w_aug = [Ws | Wa | Wf | b] [D, C1 + 1]:
//   s     = y1 * scale1 + shift1,  s_old = y2 * scale2 + shift2
//   marg  = nm if ||s - s_old|| > thr * ||s_old|| else 0
//   agg   = adjT^T @ s (+ rT)                  written before the dropout
//   y     = act(w_aug @ [drop(x3); 1])         the pre-BN activation
//   msum  = sum over the block's nodes of y * nm
// Row r < Bl reads adj_loop[r], the rest adj_dep[r - Bl], where they lie
// (Bl = 0 in the all-dep layout of a batch without loop blocks).
//
// Bound: a launch reads every block's adjacency (W*W*4 bytes, 64 KiB at
// W = 128) once, which dominates the bytes moved (the rows are ~6*D + F
// floats a node); the arcs present need 2*D flops each and the dense layer
// 2*D*(C1 + 1) a node, so the least time is set by bytes (chip_smoke.py::
// bn_bounds: 0.039 ms on the training batch's 1214 block rows).
//
// Design (K2's staging and tile2.cuh's column lists, as K14 aggregates), one
// CTA of NT threads a block row:
// - no resident adjacency: each column's nonzero entries go into a compact
//   list at staging ([16][W] weights and uint8 sources, built from coalesced
//   16-byte reads of device memory, tile2.cuh::build_col_lists), in source
//   order, so the aggregation sums the dense contraction's nonzero terms in
//   its order; a column of more than 16 entries is read from device memory,
//   every entry, so a dense block is exact. agg costs 2*D an arc, not 2*D*W
//   a node, and the adjacency is read from device memory once (the list
//   build's second pass reads it again from the caches);
// - every operand (w_aug transposed, the two affines, the node mask, y1 and
//   y2 and feats transposed into x3's rows, rT into a node-major row buffer,
//   the keep bytes) is staged with cp.async, issued together ahead of the
//   list build and waited on once;
// - s and s_old through the affines with the plain version's rounding
//   (multiply, then add: __fmul_rn, __fadd_rn), the movement test one thread
//   a node, d ascending;
// - h in the per-node kernel's order (bias first, then c ascending),
//   NT / W threads a node, each taking a block of outputs (four a
//   16-byte read of the transposed w_aug);
// - agg and y leave through the node-major row buffer [W][D | 1] by
//   coalesced writes; msum, a thread a column summing the block's nodes in
//   order, as the per-node kernel summed it. No atomics: a repeat launch is
//   bit-identical, every plan gives the same bits, and y, agg, marg and msum
//   are bit for bit the per-node kernel's.
// At the flagship's widths (W 128, D 14, F 3) a CTA of plan 0 takes 41,696
// bytes. The plans (kBnFwdPlans: threads, list room, keep bytes staged) are
// mirrored by ops/bn.py::_bn_fwd_plan; the last (128 threads) builds no lists
// and stages no keep bytes, and fits every shape the per-node kernel that
// this replaces took. A thread's outputs go through h [JT] in chunks of JT
// (one chunk up to D 64), so every plan takes any D its layout fits.
//
// The wide plan (index 2, 256 threads with the lists; mirrored by
// ops/bn.py::_bn_fwd_wide), chosen only where no staged plan fits, takes
// every D: x3 and the row buffer lie in a device-memory workspace the
// wrapper allocates (a block row's slice each, gnn_bn_forward_workspace
// floats), w_aug, the affines and the keep bytes are read through the
// caches, and shared memory holds only nm, the column lists and the list
// build's counts (11,904 bytes at W 128, whatever D and F are). The code is
// the staged plans' with those pointers (the h chunks of the 64-wide
// arrays): a forced wide plan gives the staged plans' bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

// A K1 plan: threads a CTA, room of the column lists (0: the adjacency is
// read from device memory), whether the keep bytes are staged.
struct BnFwdPlan {
  int nt, E, st;
};

constexpr BnFwdPlan kBnFwdPlans[] = {{256, 16, 1}, {128, 0, 0}};
// the wide plan, after the staged ones
constexpr BnFwdPlan kBnFwdWide = {256, 16, 0};
constexpr int kBnFwdWideIndex = sizeof(kBnFwdPlans) / sizeof(kBnFwdPlans[0]);

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K1's shared memory (bytes for the list counts, sources
// and the list build's scratch, after the floats), each region a multiple of
// 16 bytes: x3 X [C1][W] (transposed; y1 and y2 first), w_aug transposed wT
// [C1 + 1][D4] (D4 = D rounded up to 4, zero past D; its last row the bias),
// the affines [4][D], nm [W], the row buffer [W][D | 1] (rT, then agg, then
// y), with st the keep bytes [W][C1], the lists [E][W]. The wide plan: x3
// and the row buffer in a block row's workspace slice of ws floats; in
// shared memory nm and the lists, then the bytes.
struct BnFwdLayout {
  int x, w, aff, nm, ab, kp, lw, ws;
  size_t cnt_b, idx_b, part_b, bytes;
};

__host__ __device__ inline BnFwdLayout fwd_layout(int W, int D, int F, const BnFwdPlan& p,
                                                  bool wide) {
  BnFwdLayout L{};
  const int C1 = 2 * D + F;
  int o = 0;
  if (wide) {
    L.x = o;
    o += round4(C1 * W);
    L.ab = o;
    o += round4(W * (D | 1));
    L.ws = o;
    L.w = L.aff = L.kp = -1;
    o = 0;
    L.nm = o;
    o += round4(W);
    L.lw = o;
    o += p.E * W;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.part_b = L.idx_b + (size_t)p.E * W;
    L.bytes = L.part_b + (size_t)(p.nt / 32) * W;
    return L;
  }
  L.x = o;
  o += round4(C1 * W);
  L.w = o;
  o += (C1 + 1) * round4(D);
  L.aff = o;
  o += round4(4 * D);
  L.nm = o;
  o += round4(W);
  L.ab = o;
  o += round4(W * (D | 1));
  L.kp = -1;
  if (p.st) {
    L.kp = o;
    o += round4((W * C1 + 3) / 4);
  }
  L.lw = o;
  o += p.E * W;
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + (p.E ? W : 0);
  L.part_b = L.idx_b + (size_t)p.E * W;  // build_col_lists' counts [NT / 32][W]
  L.bytes = L.part_b + (p.E ? (size_t)(p.nt / 32) * W : 0);
  L.ws = 0;
  return L;
}

// K1: one BN-training iteration over every block row, NT threads a CTA, one
// block row each; WIDE: the wide plan (ws its workspace).
template <int MAXF, int NT, bool ST, bool WIDE>
__global__ void __launch_bounds__(NT, 3)
bn_fwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
              const float* __restrict__ y1, const float* __restrict__ y2,
              const float* __restrict__ aff, const uint8_t* __restrict__ keep,
              const float* __restrict__ rT, const float* __restrict__ feats,
              const float* __restrict__ w_aug, const float* __restrict__ nm,
              float* __restrict__ y, float* __restrict__ agg, float* __restrict__ marg,
              float* __restrict__ msum, int Bl, int W, int D, int F, float thr, int act,
              int mode, float da, float db, BnFwdPlan p, float* ws) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const BnFwdLayout L = fwd_layout(W, D, F, p, WIDE);
  const int C1 = 2 * D + F, DP = D | 1, D4 = round4(D);
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  float* base = WIDE ? ws + (size_t)r * L.ws : sm;  // the regions of x3 and the row buffer
  float* X = base + L.x;
  float* wT = sm + L.w;
  const float* af = WIDE ? aff : sm + L.aff;  // [scale1; shift1; scale2; shift2] x [D]
  float* nms = sm + L.nm;
  float* A = base + L.ab;  // [W][DP]: rT, then agg, then y
  float* lw = sm + L.lw;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;
  const uint8_t* kg = mode != kNoDrop ? keep + row0 * C1 : nullptr;
  const bool kst = ST && kg != nullptr && reinterpret_cast<uintptr_t>(kg) % 16 == 0;

  // ---- staging, issued together, waited on once (wide: x3's rows and rT
  // copied into the workspace)
  if constexpr (WIDE) {
    for (int i = t; i < W * D; i += NT) {
      X[(i % D) * W + i / D] = y1[row0 * D + i];      // x3 rows [0, D): y1, then s
      X[(D + i % D) * W + i / D] = y2[row0 * D + i];  // rows [D, 2D): y2, then agg
      if (rT != nullptr) A[(i / D) * DP + i % D] = rT[row0 * D + i];
    }
    for (int i = t; i < W * F; i += NT) X[(2 * D + i % F) * W + i / F] = feats[row0 * F + i];
  } else {
    // wT [c][j] = w_aug [j][c], in w_aug's order (whole rows of it a warp)
    for (int i = t; i < (C1 + 1) * D4; i += NT) {
      const int j = i / (C1 + 1), c = i % (C1 + 1);
      if (j < D)
        cp_async4(wT + c * D4 + j, w_aug + i);
      else
        wT[c * D4 + j] = 0.0f;
    }
    for (int i = t; i < 4 * D; i += NT) cp_async4(sm + L.aff + i, aff + i);
    stage_rowsT(y1 + row0 * D, W, D, X, 0);  // x3 rows [0, D): y1, then s
    stage_rowsT(y2 + row0 * D, W, D, X, D);  // rows [D, 2D): y2, then agg
    stage_rowsT(feats + row0 * F, W, F, X, 2 * D);
    if (rT != nullptr)
      for (int i = t; i < W * D; i += NT) cp_async4(A + (i / D) * DP + i % D, rT + row0 * D + i);
  }
  cp_rows(nms, nm + row0, W);
  if (kst)  // W * C1 is a multiple of 32
    for (int i = 16 * t; i < W * C1; i += 16 * NT)
      cp_async16(sm + L.kp + i / 4, reinterpret_cast<const float*>(kg + i));
  if (p.E > 0) build_col_lists(adj, W, p.E, lw, idx, cnt, bytes + L.part_b);
  cp_async_wait_all();
  __syncthreads();
  const uint8_t* kp = kst ? reinterpret_cast<const uint8_t*>(sm + L.kp) : kg;

  // ---- s and s_old through the affines (multiply, then add, as the plain
  // version rounds them), the movement test one thread a node, d ascending
  for (int n = t; n < W; n += NT) {
    float dist2 = 0.0f, norm2 = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float s = __fadd_rn(__fmul_rn(X[d * W + n], af[d]), af[D + d]);
      const float so = __fadd_rn(__fmul_rn(X[(D + d) * W + n], af[2 * D + d]), af[3 * D + d]);
      X[d * W + n] = s;
      const float diff = __fsub_rn(s, so);
      dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
      norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
    }
    marg[row0 + n] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[n] : 0.0f;
  }
  __syncthreads();  // X rows [0, D) hold s; y2 is read

  // ---- agg = adjT^T @ s (+ rT) into x3 rows [D, 2D) and the row buffer
  for (int i = t; i < W * D; i += NT) {
    const int n = i % W, d = i / W;
    float a = line_dot(adj, W, n, true, p.E, lw, idx, cnt, X + d * W);
    if (rT != nullptr) a += A[n * DP + d];
    A[n * DP + d] = a;
    X[(D + d) * W + n] = a;
  }
  __syncthreads();

  // ---- agg out (before the dropout), x3 dropped in place
  for (int i = t; i < W * D; i += NT) agg[row0 * D + i] = A[(i / D) * DP + i % D];
  if (mode != kNoDrop)
    for (int i = t; i < C1 * W; i += NT) {
      const int c = i / W, n = i % W;
      X[i] = drop(mode, da, db, X[i], kp[n * C1 + c] != 0);
    }
  __syncthreads();

  // ---- y = act(h), h in the per-node order (bias first, then c ascending)
  // for outputs jc + i of node n, JT at a time from jc = j0 (one chunk up to
  // D 64), four a 16-byte read of wT (wide: four rows of w_aug); into the
  // row buffer (agg is out)
  constexpr int JT = MAXF * kMaxW / NT;
  const int tpn = NT / W, n = t % W, part = t / W;
  const int JB = round4((D + tpn - 1) / tpn), j0 = part * JB, j1 = min(D, j0 + JB);
  auto wcol = [&](int c, int j, float (&w)[4]) {  // w[u] = w_aug [j + u][c], zero past D
    if constexpr (WIDE) {
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = j + u < D ? w_aug[(size_t)(j + u) * (C1 + 1) + c] : 0.0f;
    } else {
      ldv<4>(wT + c * D4 + j, w);
    }
  };
  for (int jc = j0; part < tpn && jc < j1; jc += JT) {
    float h[JT];
#pragma unroll
    for (int q = 0; q < JT; q += 4) {
      float b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (jc + q < j1) wcol(C1, jc + q, b4);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[q + u] = b4[u];
    }
    for (int c = 0; c < C1; ++c) {
      const float x = X[c * W + n];
#pragma unroll
      for (int q = 0; q < JT; q += 4) {
        if (jc + q < j1) {
          float w4[4];
          wcol(c, jc + q, w4);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[q + u] = fmaf(w4[u], x, h[q + u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < JT; ++i)
      if (jc + i < j1) A[n * DP + jc + i] = activate(act, h[i]);
  }
  __syncthreads();

  // ---- y out; msum, a thread a column summing the block's nodes in order
  for (int i = t; i < W * D; i += NT) y[row0 * D + i] = A[(i / D) * DP + i % D];
  for (int d = t; d < D; d += NT) {
    float s = 0.0f;
    for (int m = 0; m < W; ++m) s = fmaf(A[m * DP + d], nms[m], s);
    msum[(size_t)r * D + d] = s;
  }
}

bool shape_ok(int R, int Bl, int W, int D, int F) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0;
}

int g_force = -1;  // gnn_bn_forward_force_plan

using BnFwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const uint8_t*, const float*, const float*, const float*, const float*,
                         float*, float*, float*, float*, int, int, int, int, float, int, int,
                         float, float, BnFwdPlan, float*);

template <int MAXF>
BnFwdFn fwd_variant(const BnFwdPlan& p) {
  return p.st ? bn_fwd_kernel<MAXF, 256, true, false> : bn_fwd_kernel<MAXF, 128, false, false>;
}

// K1's kernel and plan for a shape: the first plan of kBnFwdPlans that fits
// a CTA, else the wide plan (index kBnFwdWideIndex), or plan g_force (>= 0)
// if it fits; nullptr if none. The staged plans' register arrays are 16, 32
// or 64 wide by D (64 above it, in chunks); *ws: the plan's workspace floats
// a block row.
BnFwdFn pick_fwd(int W, int D, int F, BnFwdPlan* p, size_t* bytes, int* index, int* ws) {
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i <= kBnFwdWideIndex; ++i) {
    const bool wide = i == kBnFwdWideIndex;
    const BnFwdPlan plan = wide ? kBnFwdWide : kBnFwdPlans[i];
    const BnFwdLayout L = fwd_layout(W, D, F, plan, wide);
    *bytes = L.bytes;
    if (L.bytes <= (size_t)kMaxSmemBytes) {
      *p = plan;
      *index = i;
      *ws = L.ws;
      break;
    }
    if (g_force >= 0) break;
  }
  if (*index < 0) return nullptr;
  if (*index == kBnFwdWideIndex) return bn_fwd_kernel<64, 256, false, true>;
  return D <= 16 ? fwd_variant<16>(*p) : D <= 32 ? fwd_variant<32>(*p) : fwd_variant<64>(*p);
}

}  // namespace

extern "C" {

// adj_loop [Bl, W, W] (null when Bl == 0), adj_dep [R - Bl, W, W] (null when
// Bl == R); y1, y2, rT (nullable) [R, W, D]; aff [2, 2, D]; keep uint8
// [R, W, 2D + F] (null when mode == 0); feats [R, W, F]; w_aug [D, 2D + F + 1];
// nm [R, W] -> y, agg [R, W, D], marg [R, W], msum [R, D]; ws: the wide
// plan's workspace, R slices of gnn_bn_forward_workspace floats (null for a
// staged plan). Returns a cudaError_t code.
int gnn_bn_forward(const float* adj_loop, const float* adj_dep, const float* y1,
                   const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                   const float* feats, const float* w_aug, const float* nm, float* y,
                   float* agg, float* marg, float* msum, int R, int Bl, int W, int D, int F,
                   float thr, int act, int mode, float da, float db, void* stream, float* ws) {
  if (!shape_ok(R, Bl, W, D, F)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  BnFwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnFwdFn fn = pick_fwd(W, D, F, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, y, agg, marg, msum, Bl, W, D,
      F, thr, act, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block row gnn_bn_forward's plan for this shape
// needs (0 for a staged plan), or -1 if no plan fits (H1 unused).
int gnn_bn_forward_workspace(int W, int D, int F, int H1) {
  (void)H1;
  BnFwdPlan p;
  size_t bytes;
  int index, wsf;
  return pick_fwd(W, D, F, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bn_forward launches for
// this shape (H1 unused). Returns a cudaError_t code.
int gnn_bn_forward_info(int W, int D, int F, int H1, int* out) {
  (void)H1;
  BnFwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnFwdFn fn = pick_fwd(W, D, F, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` (kBnFwdPlans, then the wide plan) from now on, where it
// fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_bn_forward_force_plan(int index) { g_force = index; }

}  // extern "C"
