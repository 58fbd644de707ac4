// Dropout-training propagation kernels of the GNN fixed-point loop for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16), for a state
// net of one dense layer with input dropout and no BatchNorm.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K6 _train_kernel_T        (launched by _train_fwd_impl)      -> gnn_train_step
//   K7 _loop_train_kernel_T   (launched by _loop_train_impl)     -> gnn_train_loop
// K7's reverse, K8, is in train_loop_bwd.cu.
//
// One training iteration on one W-node block, node-major rows; the arc-label
// slice of the dense input is dropped and folded into fT outside:
//   agg = adjT^T @ s (+ rT)             agg[dst] = sum_src adjT[src, dst] * s[src]
//   x2  = [drop(s, ms) | drop(agg, ma)] the dense input's state and agg slices
//   s'  = act(w_cat @ x2 + fT)          w_cat = [Ws | Wa], [H, 2D]
// The dropout sits between the aggregation and Wa, so Wa cannot be moved
// through the aggregation as in K3: the aggregation is D wide.
// K7 runs all K iterations of a residual-free block with a fresh fT[k] and
// masks per iteration, and writes the state after every iteration (traj),
// the pre-update movement flags (marg) and the pre-dropout aggregations
// (agg, saved for K8): marg[k] = nm where ||s - s_old|| > thr ||s_old||.
// K6 runs one iteration of a residual-coupled block: the state slice arrives
// dropped (sd), the raw residual aggregation rT is added before the aggregated
// slice's dropout; its backward is plain PyTorch, as gnn_tpu's is XLA.
//
// Bound: K7 reads each block's adjacency (64 KiB at W = 128) once for all K
// iterations and streams K per-iteration rows (fT and two keep-byte rows in;
// traj and agg out), about two thirds of its bytes; the dense layer costs
// 4*D*D flops a node and iteration and the arcs present 2*D each, so the
// least time is set by bytes (chip_smoke.py::bnfree_bounds: 0.0663 ms on the
// training batch's 1104 loop rows, K = 5). K6 is the same for one iteration
// (0.0036 ms at the 110 dep rows); at those rows a launch is 110 CTAs, less
// than one wave, and its time is one CTA's staging, list build and products
// end to end.
//
// K7's design (K3's, eval_loop.cu, with the dropout between the aggregation
// and Wa), one CTA of NT threads a block row:
// - no resident adjacency: each column's nonzero entries go into a compact
//   list ([8][W] weights and uint8 sources, tile2.cuh::build_col_lists, from
//   coalesced 16-byte reads) once a launch, in source order, and all K
//   iterations aggregate over it: 2*D an arc, not the dense W*W contraction.
//   A column of more than 8 entries is read from device memory, every entry,
//   so a dense block is exact;
// - w_cat transposed, nm, s0 and iteration 0's fT rows and keep bytes are
//   staged with cp.async, issued together ahead of the list build and
//   waited on once; each later iteration's fT rows and keep bytes are copied
//   with cp.async while the iteration aggregates;
// - the aggregation one thread a node and four of its columns, walking the
//   node's list once, src ascending from 0 as the dense sum associated it,
//   into a node-major buffer and out to agg[k]; traj[k - 1] goes out in the
//   same pass;
// - the dense layer on NT / W threads a node, eight outputs at a time (two
//   arrays of four) from 16-byte reads of the transposed w_cat, each a chain
//   over the 2D inputs with c ascending from 0, the inputs dropped as
//   they are read (the same common.cuh::drop), fT added after the chain; s'
//   goes into the state buffer s_old leaves. No register array is wider
//   than four;
// - the movement test one thread a node, d ascending, with the per-node
//   rounding (__fadd_rn, __fmul_rn). Two barriers an iteration.
// No atomics: a repeat launch is bit-identical, and traj, marg and agg are
// bit for bit the per-node K7's (K8 reads traj and agg). The staged plan
// (kTrainLoopThreads, kTrainLoopLists) takes W 32..128 up to D 64 at W 128
// (188,032 bytes there). At W 128, D 14 a CTA takes 41,856 bytes and five
// CTAs fit an SM: on an NVIDIA H100 0.166 ms of device time at the training
// batch's 1104 loop rows against the per-node kernel's 0.92 (four CTAs an
// SM: 0.201; PERF.md §6). The wide plan (index 1; mirrored by
// ops/fused.py::_train_loop_wide) takes every D where the staged plan does
// not fit: 6,784 bytes at W 128 (nm and the lists), the state, agg and the
// next state in traj and agg themselves, no workspace.
//
// K6's design (K7's for one iteration with K4's residual term and widths,
// fused_eval.cu), one CTA of NT threads a dep block row:
// - each column's nonzero entries go into a compact list ([16][W] weights
//   and uint8 sources, tile2.cuh::build_col_lists, from coalesced 16-byte
//   reads), in source order; a column of more than 16 entries is read from
//   device memory, every entry, so a dense block is exact;
// - w_cat transposed, s, sd, rT, fT and the aggregated slice's keep bytes
//   are staged with cp.async, issued together ahead of the list build and
//   waited on once;
// - the aggregation one thread a node and four of its columns, walking the
//   node's list once, src ascending from 0 as the dense sum associated it,
//   then + rT, into a node-major buffer and out to agg (before the dropout;
//   the plain backward reads it);
// - the dense layer on NT / W threads a node, eight outputs at a time (two
//   arrays of four) from 16-byte reads of the transposed w_cat, each a chain
//   over [sd | drop(agg)] with c ascending from 0, the aggregated half dropped
//   as it is read (common.cuh::drop), then + fT, straight to device memory.
//   H may differ from D (the state read D wide, written H wide, as K4).
// Two barriers a launch, no atomics: a repeat launch is bit-identical, and y
// and agg are bit for bit the per-node K6's (fmaf over src ascending, + rT;
// fmaf over c ascending, + fT). The staged plan (kTrainStepThreads,
// kTrainStepLists) takes W 32..128 up to D = H = 64 at W 128 (217,728 bytes
// there); at W 128, D = H = 14 a CTA takes 52,352 bytes, four CTAs an SM.
// The wide plan (index 1; mirrored by ops/fused.py::_train_step_wide) takes
// every D and H where the staged plan does not fit: 11,392 bytes at W 128
// (the lists), agg in its output, no workspace.

#include "tile2.cuh"

namespace {

using namespace gnn;

// K7's plan: threads a CTA and the room of the column lists; the launch
// bounds hold a thread to 48 registers, five CTAs an SM at the flagship's
// widths. On an NVIDIA H100 at the flagship's training batch (PERF.md §6),
// 128 threads without lists ran 0.4223 ms of device time against 0.166; a
// plan that prefetched the next iteration's fT rows and keep bytes into
// second buffers (53,120 bytes, four CTAs an SM) 0.2030 against 0.2014
// without the prefetch at the same four CTAs, and one that read the keep
// bytes from device memory where they are used 0.1838 against 0.1831 at
// five CTAs. None was kept. The wide plan has the same threads and lists.
constexpr int kTrainLoopThreads = 256, kTrainLoopLists = 8;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K7's shared memory (bytes for the keep bytes and the
// lists, after the floats), each region a multiple of 16 bytes: two state
// buffers [W][D | 1] (s, then each iteration's s' into the one s_old leaves),
// agg [W][D | 1] (the second state buffer and agg hold the list build's
// counts [NT / 32][W], as bytes, before the first iteration), fT [W][D | 1],
// w_cat transposed wT [2D][D4] (D4 = D rounded up to 4, zero past D), nm [W],
// the lists [kTrainLoopLists][W]; then the keep bytes [2][W D] (the state
// slice's, then agg's, node-major), the list counts [W] and sources
// [kTrainLoopLists][W]. The wide plan: nm, the lists, then the counts, the
// sources and the list build's counts [NT / 32][W] as bytes.
struct TrainLoopLayout {
  int s0, s1, agg, f, w, nm, lw;
  size_t keep_b, cnt_b, idx_b, part_b, bytes;
};

__host__ __device__ inline TrainLoopLayout train_loop_layout(int W, int D, bool wide) {
  TrainLoopLayout L{};
  int o = 0;
  if (wide) {
    L.s0 = L.s1 = L.agg = L.f = L.w = -1;
    L.nm = o;
    o += round4(W);
    L.lw = o;
    o += kTrainLoopLists * W;
    L.keep_b = L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.part_b = L.idx_b + (size_t)kTrainLoopLists * W;
    L.bytes = L.part_b + (size_t)(kTrainLoopThreads / 32) * W;
    return L;
  }
  const int rows = round4(W * (D | 1));
  L.s0 = o;
  o += rows;
  L.s1 = o;
  o += rows;
  L.agg = o;
  o += rows;
  L.f = o;
  o += rows;
  L.w = o;
  o += 2 * D * round4(D);
  L.nm = o;
  o += round4(W);
  L.lw = o;
  o += kTrainLoopLists * W;
  L.keep_b = sizeof(float) * (size_t)o;
  L.cnt_b = L.keep_b + (size_t)2 * W * D;
  L.idx_b = L.cnt_b + W;
  L.bytes = L.idx_b + (size_t)kTrainLoopLists * W;
  L.part_b = 0;
  return L;
}

// K7: all K dropout-training iterations of residual-free blocks (H == D),
// NT threads a CTA, one block row each. WIDE, the wide plan (chosen only
// where the staged plan does not fit; every D): shared memory holds only nm
// and the column lists; s is read from s0 or traj[k - 1] and s_old from
// traj[k - 2], agg is written to agg[k] and read back from there, s' goes
// straight to traj[k] (this CTA's rows, plain loads after a barrier), and
// fT, the keep bytes and w_cat are read from device memory through the
// caches. The same chains in the same orders: a forced wide plan gives the
// staged plan's bits.
template <bool WIDE>
__global__ void __launch_bounds__(kTrainLoopThreads, 5)
train_loop_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                  const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                  const float* __restrict__ fT, const float* __restrict__ w_cat,
                  const float* __restrict__ nm, float* __restrict__ traj,
                  float* __restrict__ marg, float* __restrict__ agg_out, int B, int W, int D,
                  int K, float thr, int act, int mode, float da, float db) {
  constexpr int NT = kTrainLoopThreads, E = kTrainLoopLists;
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const TrainLoopLayout L = train_loop_layout(W, D, WIDE);
  // the rows' stride: [W][D | 1] buffers, or (wide) the operands themselves
  const int DP = WIDE ? D : (D | 1), C2 = 2 * D, D4 = round4(D), WD = W * D;
  const bool drops = mode != kNoDrop;
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  const float* cur = WIDE ? s0 + row0 * D : sm + L.s0;  // s
  const float* old = WIDE ? nullptr : sm + L.s1;        // s_old
  // iteration k's agg, fT and keep bytes [W D] of the state slice and of agg:
  // shared-memory buffers, or (wide) where they lie in device memory
  float* A = sm + L.agg;
  const float* F = sm + L.f;
  const uint8_t* KS = bytes + L.keep_b;
  const uint8_t* KA = KS + WD;
  float* wT = sm + L.w;
  float* nms = sm + L.nm;
  float* lw = sm + L.lw;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;

  // iteration k's rows: fT[k] and its keep bytes
  auto stage_rows = [&](int k) {
    const size_t kb = (size_t)k * B + b;
    for (int i = t; i < WD; i += NT) cp_async4(sm + L.f + (i / D) * DP + i % D, fT + kb * WD + i);
    if (drops) {
      float* ks = reinterpret_cast<float*>(bytes + L.keep_b);
      cp_rows(ks, reinterpret_cast<const float*>(ms + kb * WD), WD / 4);
      cp_rows(ks + WD / 4, reinterpret_cast<const float*>(ma + kb * WD), WD / 4);
    }
  };

  // ---- staging, issued together, waited on once
  if constexpr (!WIDE) {
    // wT [c][j] = w_cat [j][c], in w_cat's order (whole rows of it a warp)
    for (int i = t; i < D4 * C2; i += NT) {
      const int j = i / C2, c = i % C2;
      if (j < D)
        cp_async4(wT + c * D4 + j, w_cat + i);
      else
        wT[c * D4 + j] = 0.0f;
    }
  }
  cp_rows(nms, nm + row0, W);
  if constexpr (!WIDE) {
    for (int i = t; i < WD; i += NT) cp_async4(sm + L.s0 + (i / D) * DP + i % D, s0 + row0 * D + i);
    stage_rows(0);
  }
  build_col_lists(adj, W, E, lw, idx, cnt,
                  WIDE ? bytes + L.part_b : reinterpret_cast<uint8_t*>(sm + L.s1));
  cp_async_wait_all();
  __syncthreads();

  // s' outputs [j0, j1) of node n are thread t's
  const int tpn = NT / W, n = t % W, part = t / W;
  const int JB = round4((D + tpn - 1) / tpn), j0 = part * JB, j1 = min(D, j0 + JB);
  const int NB = (D + 3) / 4;  // blocks of four columns a node
  for (int k = 0; k < K; ++k) {
    const size_t kb = (size_t)k * B + b;
    if (!WIDE && k > 0) stage_rows(k);  // waited on before the dense layer
    if constexpr (WIDE) {  // iteration k's rows where they lie
      A = agg_out + kb * WD;
      F = fT + kb * WD;
      KS = drops ? ms + kb * WD : nullptr;
      KA = drops ? ma + kb * WD : nullptr;
    }

    // ---- the movement test before update k, one thread a node, d ascending
    for (int m = t; m < W; m += NT) {
      float dist2 = 0.0f, norm2 = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float s = cur[m * DP + d], so = k > 0 ? old[m * DP + d] : 1.0f;
        const float diff = __fsub_rn(s, so);
        dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
        norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
      }
      marg[kb * W + m] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[m] : 0.0f;
    }

    // ---- agg = adjT^T @ s over the column lists (src ascending), four
    // columns of node m an item, out to agg[k] (wide: agg[k] alone); s
    // (iteration k - 1's s') out to traj[k - 1] (wide: written there
    // already), node-major
    float* ao = agg_out + kb * WD;
    float* to = !WIDE && k > 0 ? traj + (kb - B) * WD : nullptr;
    for (int i = t; i < W * NB; i += NT) {
      const int m = i / NB, h0 = 4 * (i % NB), nh = min(4, D - h0);
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int c = cnt[m];
      if (c <= E) {
        for (int e = 0; e < c; ++e) {
          const float w = lw[e * W + m];
          const float* r = cur + idx[e * W + m] * DP + h0;
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (v < nh) a[v] = fmaf(w, r[v], a[v]);
        }
      } else {
        for (int src = 0; src < W; ++src) {
          const float w = adj[(size_t)src * W + m];
          const float* r = cur + src * DP + h0;
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (v < nh) a[v] = fmaf(w, r[v], a[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (v < nh) {
          if (!WIDE) A[m * DP + h0 + v] = a[v];
          ao[m * D + h0 + v] = a[v];
          if (to != nullptr) to[m * D + h0 + v] = cur[m * DP + h0 + v];
        }
    }
    cp_async_wait_all();
    __syncthreads();  // agg is full; s_old is read; iteration k's rows are in

    // ---- s' = act(w_cat @ [drop(s, ms[k]) | drop(agg, ma[k])] + fT[k]), four
    // outputs a 16-byte read of wT (wide: four rows of w_cat), each a chain
    // over c from 0, into the buffer s_old leaves (wide: traj[k])
    float* nxt = WIDE ? traj + kb * WD : const_cast<float*>(old);
    if (part < tpn)
      for (int q = j0; q < j1; q += 8) {  // outputs q .. q + 3 in u, q + 4 .. q + 7 in u2
        const bool two = q + 4 < j1;
        float u[4] = {0.0f, 0.0f, 0.0f, 0.0f}, u2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float w4[4];
        auto wrow = [&](int c, int j) {  // w4 = w_cat [j .. j + 3][c], zero past D
          if constexpr (WIDE) {
#pragma unroll
            for (int v = 0; v < 4; ++v) w4[v] = j + v < D ? w_cat[(size_t)(j + v) * C2 + c] : 0.0f;
          } else {
            ldv<4>(wT + c * D4 + j, w4);
          }
        };
        for (int c = 0; c < C2; ++c) {
          const bool st = c < D;
          const float x = drop(mode, da, db, st ? cur[n * DP + c] : A[n * DP + c - D],
                               drops && (st ? KS[n * D + c] : KA[n * D + c - D]) != 0);
          wrow(c, q);
#pragma unroll
          for (int v = 0; v < 4; ++v) u[v] = fmaf(w4[v], x, u[v]);
          if (two) {
            wrow(c, q + 4);
#pragma unroll
            for (int v = 0; v < 4; ++v) u2[v] = fmaf(w4[v], x, u2[v]);
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (q + v < j1) nxt[n * DP + q + v] = activate(act, u[v] + F[n * DP + q + v]);
          if (q + 4 + v < j1)
            nxt[n * DP + q + 4 + v] = activate(act, u2[v] + F[n * DP + q + 4 + v]);
        }
      }
    __syncthreads();  // s' is full; s, agg and iteration k's rows are read
    old = cur;
    cur = nxt;
  }
  if constexpr (!WIDE) {
    float* to = traj + ((size_t)(K - 1) * B + b) * WD;
    for (int i = t; i < WD; i += NT) to[i] = cur[(i / D) * DP + i % D];
  }
}

// K6's plan: threads a CTA and the room of the column lists (K4's); the
// launch bounds hold a thread to 64 registers, four CTAs an SM at the
// flagship's widths. The wide plan has the same threads and lists.
constexpr int kTrainStepThreads = 256, kTrainStepLists = 16;

// Float offsets of K6's shared memory (bytes for the keep bytes and the
// lists, after the floats), each region a multiple of 16 bytes: s, sd, agg
// and rT [W][D | 1] (agg at least [2][W], since it holds the list build's
// counts [NT / 32][W], as bytes, before the aggregation), fT [W][H | 1], w_cat
// transposed wT [2D][H4] (H4 = H rounded up to 4, zero past H), the lists
// [kTrainStepLists][W]; then the keep bytes [W D] of the aggregated slice,
// node-major, the list counts [W] and sources [kTrainStepLists][W]. The wide
// plan: the lists, then the counts, the sources and the list build's counts
// [NT / 32][W] as bytes.
struct TrainStepLayout {
  int s, sd, agg, r, f, w, lw;
  size_t keep_b, cnt_b, idx_b, part_b, bytes;
};

__host__ __device__ inline TrainStepLayout train_step_layout(int W, int D, int H, bool wide) {
  TrainStepLayout L{};
  int o = 0;
  if (wide) {
    L.s = L.sd = L.agg = L.r = L.f = L.w = -1;
    L.lw = o;
    o += kTrainStepLists * W;
    L.keep_b = L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.part_b = L.idx_b + (size_t)kTrainStepLists * W;
    L.bytes = L.part_b + (size_t)(kTrainStepThreads / 32) * W;
    return L;
  }
  const int rows = round4(W * (D | 1));
  L.s = o;
  o += rows;
  L.sd = o;
  o += rows;
  L.agg = o;
  o += rows > 2 * W ? rows : 2 * W;
  L.r = o;
  o += rows;
  L.f = o;
  o += round4(W * (H | 1));
  L.w = o;
  o += 2 * D * round4(H);
  L.lw = o;
  o += kTrainStepLists * W;
  L.keep_b = sizeof(float) * (size_t)o;
  L.cnt_b = L.keep_b + (size_t)W * D;
  L.idx_b = L.cnt_b + W;
  L.bytes = L.idx_b + (size_t)kTrainStepLists * W;
  L.part_b = 0;
  return L;
}

// K6: one dropout-training iteration over every dep block row, NT threads a
// CTA, one block row each; rT and keep (the aggregated slice's keep bytes)
// may be null. WIDE, the wide plan (chosen only where the staged plan does
// not fit; every D and H): shared memory holds only the column lists; s, sd,
// rT, fT, the keep bytes and w_cat are read from device memory through the
// caches, and agg is written to its output and read back from there (this
// CTA's rows, plain loads after a barrier). The same chains: a forced wide
// plan gives the staged plan's bits.
template <bool WIDE>
__global__ void __launch_bounds__(kTrainStepThreads, 4)
train_step_kernel(const float* __restrict__ adjT, const float* __restrict__ s,
                  const float* __restrict__ sd, const uint8_t* __restrict__ keep,
                  const float* __restrict__ rT, const float* __restrict__ fT,
                  const float* __restrict__ w_cat, float* __restrict__ y,
                  float* __restrict__ agg_out, int W, int D, int H, int act, int mode, float da,
                  float db) {
  constexpr int NT = kTrainStepThreads, E = kTrainStepLists;
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const TrainStepLayout L = train_step_layout(W, D, H, WIDE);
  // row strides: [W][D | 1] and [W][H | 1] buffers, or (wide) the operands
  const int DP = WIDE ? D : (D | 1), HP = WIDE ? H : (H | 1), C2 = 2 * D, H4 = round4(H);
  const bool drops = mode != kNoDrop, has_res = rT != nullptr;
  const int t = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * W;
  const float* adj = adjT + row0 * W;
  const float* S = WIDE ? s + row0 * D : sm + L.s;
  const float* X = WIDE ? sd + row0 * D : sm + L.sd;
  float* A = WIDE ? agg_out + row0 * D : sm + L.agg;
  const float* R = WIDE ? rT + row0 * D : sm + L.r;
  const float* F = WIDE ? fT + row0 * H : sm + L.f;
  float* wT = sm + L.w;
  float* lw = sm + L.lw;
  // [W D] keep bytes of the aggregated slice
  const uint8_t* KA = WIDE ? (drops ? keep + row0 * D : nullptr) : bytes + L.keep_b;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;

  // ---- staging, issued together, waited on once
  if constexpr (!WIDE) {
    // wT [c][j] = w_cat [j][c], in w_cat's order (whole rows of it a warp)
    for (int i = t; i < H4 * C2; i += NT) {
      const int j = i / C2, c = i % C2;
      if (j < H)
        cp_async4(wT + c * H4 + j, w_cat + i);
      else
        wT[c * H4 + j] = 0.0f;
    }
    for (int i = t; i < W * D; i += NT) {
      const int o = (i / D) * DP + i % D;
      cp_async4(sm + L.s + o, s + row0 * D + i);
      cp_async4(sm + L.sd + o, sd + row0 * D + i);
      if (has_res) cp_async4(sm + L.r + o, rT + row0 * D + i);
    }
    for (int i = t; i < W * H; i += NT)
      cp_async4(sm + L.f + (i / H) * HP + i % H, fT + row0 * H + i);
    if (drops)
      cp_rows(reinterpret_cast<float*>(bytes + L.keep_b),
              reinterpret_cast<const float*>(keep + row0 * D), W * D / 4);
  }
  build_col_lists(adj, W, E, lw, idx, cnt,
                  WIDE ? bytes + L.part_b : reinterpret_cast<uint8_t*>(A));
  cp_async_wait_all();
  __syncthreads();

  // ---- agg = adjT^T @ s over the column lists (src ascending) (+ rT), four
  // columns of node m an item, into A and out to agg (wide: A is agg)
  float* ao = agg_out + row0 * D;
  const int NB = (D + 3) / 4;  // blocks of four columns a node
  for (int i = t; i < W * NB; i += NT) {
    const int m = i / NB, h0 = 4 * (i % NB), nh = min(4, D - h0);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int c = cnt[m];
    if (c <= E) {
      for (int e = 0; e < c; ++e) {
        const float w = lw[e * W + m];
        const float* r = S + idx[e * W + m] * DP + h0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < nh) a[v] = fmaf(w, r[v], a[v]);
      }
    } else {
      for (int src = 0; src < W; ++src) {
        const float w = adj[(size_t)src * W + m];
        const float* r = S + src * DP + h0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < nh) a[v] = fmaf(w, r[v], a[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < nh) {
        if (has_res) a[v] += R[m * DP + h0 + v];
        if (!WIDE) A[m * DP + h0 + v] = a[v];
        ao[m * D + h0 + v] = a[v];
      }
  }
  __syncthreads();  // agg is full

  // ---- y = act(w_cat @ [sd | drop(agg, m)] + fT), eight outputs a pass (two
  // arrays of four) from 16-byte reads of wT (wide: rows of w_cat), each a
  // chain over c from 0; outputs [j0, j1) of node n are thread t's
  const int tpn = NT / W, n = t % W, part = t / W;
  const int JB = round4((H + tpn - 1) / tpn), j0 = part * JB, j1 = min(H, j0 + JB);
  float* yo = y + (row0 + n) * H;
  if (part < tpn)
    for (int q = j0; q < j1; q += 8) {  // outputs q .. q + 3 in u, q + 4 .. q + 7 in u2
      const bool two = q + 4 < j1;
      float u[4] = {0.0f, 0.0f, 0.0f, 0.0f}, u2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float w4[4];
      auto wrow = [&](int c, int j) {  // w4 = w_cat [j .. j + 3][c], zero past H
        if constexpr (WIDE) {
#pragma unroll
          for (int v = 0; v < 4; ++v) w4[v] = j + v < H ? w_cat[(size_t)(j + v) * C2 + c] : 0.0f;
        } else {
          ldv<4>(wT + c * H4 + j, w4);
        }
      };
      for (int c = 0; c < C2; ++c) {
        const float x = c < D ? X[n * DP + c]
                              : drop(mode, da, db, A[n * DP + c - D],
                                     drops && KA[n * D + c - D] != 0);
        wrow(c, q);
#pragma unroll
        for (int v = 0; v < 4; ++v) u[v] = fmaf(w4[v], x, u[v]);
        if (two) {
          wrow(c, q + 4);
#pragma unroll
          for (int v = 0; v < 4; ++v) u2[v] = fmaf(w4[v], x, u2[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (q + v < j1) yo[q + v] = activate(act, u[v] + F[n * HP + q + v]);
        if (q + 4 + v < j1) yo[q + 4 + v] = activate(act, u2[v] + F[n * HP + q + 4 + v]);
      }
    }
}

bool drop_ok(int mode, const uint8_t* a, const uint8_t* b) {
  return mode == kNoDrop || (a != nullptr && b != nullptr);
}

int g_force_loop = -1;  // gnn_train_loop_force_plan
int g_force_step = -1;  // gnn_train_step_force_plan

// The plan index of K7 (loop) or K6 for a shape: 0, the staged plan, where
// it fits a CTA, else 1, the wide plan, or plan `force` (>= 0) if it fits;
// -1 if none. *bytes: the plan's shared memory.
template <typename Bytes>
int pick_plan01(int force, size_t* bytes, Bytes layout_bytes) {
  for (int i = force >= 0 ? force : 0; i <= 1; ++i) {
    *bytes = layout_bytes(i == 1);
    if (*bytes <= (size_t)kMaxSmemBytes) return i;
    if (force >= 0) break;
  }
  return -1;
}

int pick_loop(int W, int D, size_t* bytes) {
  return pick_plan01(g_force_loop, bytes,
                     [&](bool wide) { return train_loop_layout(W, D, wide).bytes; });
}

int pick_step(int W, int D, int H, size_t* bytes) {
  return pick_plan01(g_force_step, bytes,
                     [&](bool wide) { return train_step_layout(W, D, H, wide).bytes; });
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], ms/ma uint8 [K, B, W, D] (null when mode == 0),
// fT [K, B, W, D], w_cat [D, 2D], nm [B, W] -> traj, agg [K, B, W, D],
// marg [K, B, W]. Returns a cudaError_t code.
int gnn_train_loop(const float* adjT, const float* s0, const uint8_t* ms, const uint8_t* ma,
                   const float* fT, const float* w_cat, const float* nm, float* traj,
                   float* marg, float* agg, int B, int W, int D, int K, float thr, int act,
                   int mode, float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || !drop_ok(mode, ms, ma))
    return cudaErrorInvalidValue;
  size_t bytes;
  const int index = pick_loop(W, D, &bytes);
  if (index < 0) return cudaErrorInvalidValue;
  const auto fn = index == 1 ? train_loop_kernel<true> : train_loop_kernel<false>;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTrainLoopThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, ms, ma, fT, w_cat, nm, traj, marg, agg, B, W, D, K, thr, act, mode, da, db);
  return cudaGetLastError();
}

// out[0..4]: plan index (0 the staged plan, 1 the wide plan), shared-memory
// bytes, resident CTAs an SM, registers a thread, local bytes a thread of
// the kernel gnn_train_loop launches for this shape (AL and H1 unused).
// Returns a cudaError_t code.
int gnn_train_loop_info(int W, int D, int AL, int H1, int* out) {
  (void)AL;
  (void)H1;
  size_t bytes;
  const int index = pick_loop(W, D, &bytes);
  if (index < 0) return cudaErrorInvalidValue;
  return tile_kernel_info(index == 1 ? train_loop_kernel<true> : train_loop_kernel<false>,
                          bytes, index, out, kTrainLoopThreads);
}

// Launch plan `index` of K7 (0 the staged plan, 1 the wide plan) from now
// on, where it fits (a launch at a shape it does not fit fails), or the
// first plan that fits again (index -1): for timing one plan against another.
void gnn_train_loop_force_plan(int index) { g_force_loop = index; }

// adjT [B, W, W], s/sd [B, W, D], m uint8 [B, W, D] (null when mode == 0),
// rT [B, W, D] (nullable), fT [B, W, H], w_cat [H, 2D] -> y [B, W, H],
// agg [B, W, D]. Returns a cudaError_t code.
int gnn_train_step(const float* adjT, const float* s, const float* sd, const uint8_t* m,
                   const float* rT, const float* fT, const float* w_cat, float* y, float* agg,
                   int B, int W, int D, int H, int act, int mode, float da, float db,
                   void* stream) {
  if (!block_ok(B, W) || D <= 0 || H <= 0 || !drop_ok(mode, m, m))
    return cudaErrorInvalidValue;
  size_t bytes;
  const int index = pick_step(W, D, H, &bytes);
  if (index < 0) return cudaErrorInvalidValue;
  const auto fn = index == 1 ? train_step_kernel<true> : train_step_kernel<false>;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTrainStepThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s, sd, m, rT, fT, w_cat, y, agg, W, D, H, act, mode, da, db);
  return cudaGetLastError();
}

// out[0..4]: plan index (0 the staged plan, 1 the wide plan), shared-memory
// bytes, resident CTAs an SM, registers a thread, local bytes a thread of
// the kernel gnn_train_step launches for this shape (H1 unused). Returns a
// cudaError_t code.
int gnn_train_step_info(int W, int D, int H, int H1, int* out) {
  (void)H1;
  size_t bytes;
  const int index = pick_step(W, D, H, &bytes);
  if (index < 0) return cudaErrorInvalidValue;
  return tile_kernel_info(index == 1 ? train_step_kernel<true> : train_step_kernel<false>,
                          bytes, index, out, kTrainStepThreads);
}

// Launch plan `index` of K6 (0 the staged plan, 1 the wide plan) from now
// on, where it fits (a launch at a shape it does not fit fails), or the
// first plan that fits again (index -1): for timing one plan against another.
void gnn_train_step_force_plan(int index) { g_force_step = index; }

}  // extern "C"
