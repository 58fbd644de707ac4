// K14, one BatchNorm-training iteration of a two-layer state net, for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16), on the
// register-tiled block products of K10's forward (tile2.cuh).
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K14 _bn2_fwd_kernel (launched by _bn2_fwd_call) -> gnn_bn2_forward
// Its reverse, K15, is in bn2_train.cu.
//
// A trailing BatchNorm couples every block each iteration through the batch
// moments, so one launch runs one iteration over every block row, and
// [D]-sized glue (ops/bn.py) runs between launches. C = 2D + F is the width
// of the dense input x3 = [s | agg | feats]; w0_aug = [Ws | Wa | Wf | b0]
// [H1, C + 1], w1 [D, H1], b1 [D]. One iteration on one W-node block:
//   s     = y1 * scale1 + shift1,  s_old = y2 * scale2 + shift2
//   marg  = nm if ||s - s_old|| > thr * ||s_old|| else 0
//   agg   = adjT^T @ s (+ rT)                  written before the dropout
//   y     = act1(w1 @ act0(w0_aug @ [drop(x3); 1]) + b1)   the pre-BN activation
//   msum  = sum over the block's nodes of y * nm
// Row r < Bl reads adj_loop[r], the rest adj_dep[r - Bl], where they lie
// (Bl = 0 in the all-dep layout of a batch without loop blocks).
//
// Bound: the hidden layer sets it, 2*H1*(3D + F + 1) flops a node, against
// about 6*D + F bytes a node read and written and the adjacency (4*W*W bytes
// a block) read once: at the hidden-150 recipe on the training batch the
// bytes bound (the adjacency) is the larger (chip_smoke.py::bound: 0.039 ms
// on 1214 block rows).
//
// Design: K10's tiled forward for one iteration, one CTA of 256 threads a
// block row:
// - h0 and h1 as block products on 4-node x 4-unit register tiles
//   (tile2.cuh first_product3, second_product), y0 through the swizzled
//   unit-major tile, two tiles in turn; not one thread a node looping over
//   H1 units with a scalar weight read a FMA at the odd stride C;
// - the aggregation by destination over compact column lists ([16][W]
//   weights and uint8 sources) built at staging from coalesced 16-byte reads
//   of the adjacency (tile2.cuh::build_col_lists), in source order, so the
//   sum has the dense contraction's nonzero terms in its order; a column of
//   more than 16 entries is read from device memory, every entry, so a dense
//   block is exact. The adjacency is read once a launch (it is the bytes
//   bound); K14 cannot amortise it over K iterations as K10 and K12 do;
// - every operand (the weights, the affines, the node mask, y1 and y2 and
//   feats transposed into x3's rows, rT into the row buffer, the keep bytes)
//   is staged with cp.async, issued together and waited on once;
// - the affines at staging with the plain version's rounding (multiply, then
//   add: __fmul_rn, __fadd_rn), the movement test one thread a node, d
//   ascending, as the per-node kernel did;
// - the per-entry uint8 keep bytes of the caller's mask, as they are;
// - h0 in the per-node kernel's association (three column chains added as
//   (s + a) + (f + b0), first_product3) and h1 in its order, so y is bit for
//   bit the per-node K14's: the h150_bn step's float32 path, whose first-layer
//   grads sit within a few 1e-4 of float64 only (BatchNorm's mean-subtracted
//   sums cancel), stays the one chip_smoke.py holds to float64 (one chain
//   from the bias, tile2.cuh's first_product, moved those grads from 1e-4 to
//   2.6e-4 of float64, norm-wise, past that check's 2e-4);
// - agg and y leave through a node-major row buffer [W][D | 1] by coalesced
//   writes; msum is a block sum, a thread a column over the block's nodes in
//   order, as the per-node kernel summed it: no atomics, so a repeat launch
//   is bit-identical, and every plan gives the same bits.
// The plans (tile2.cuh kBn2FwdPlans, mirrored by ops/fused2.py::_PLANS["K14"]):
// the first stages the keep bytes, builds the lists and stages w1, two y0
// tiles; the leanest (no lists, no keep bytes staged, w1 read from device
// memory) fits every shape the per-node K14 took. The wide plan (tile2.cuh
// kTile2Wide, chosen only where neither fits) takes every D, F and H1: x3,
// the row buffer and h1 lie in a workspace slice a block row
// (gnn_bn2_forward_workspace floats, allocated by the wrapper), the weights,
// the biases, the affines and the keep bytes are read from device memory, and
// a thread's outputs go through its 64-wide tiles a chunk at a time: the same
// chains, so a forced wide plan gives the staged plans' bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

static_assert(kBn2FwdPlans[0].ut == 4 && kBn2FwdPlans[1].ut == 4, "K14 owns 4 units a thread");

int g_force = -1;  // gnn_bn2_forward_force_plan

template <int MAXF, bool WIDE>
__global__ void __launch_bounds__(kTileThreads, 2)
bn2_fwd_tile_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
                    const float* __restrict__ y1, const float* __restrict__ y2,
                    const float* __restrict__ aff, const uint8_t* __restrict__ keep,
                    const float* __restrict__ rT, const float* __restrict__ feats,
                    const float* __restrict__ w0_aug, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ nm,
                    float* __restrict__ y, float* __restrict__ agg, float* __restrict__ marg,
                    float* __restrict__ msum, int Bl, int W, int D, int F, int H1, float thr,
                    int act0, int act1, int mode, float da, float db, Tile2Plan p, float* ws) {
  constexpr int DG = MAXF / 8, UT = 4, CH = 8 * UT;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kBnForward2, W, D, F, H1, p, WIDE);
  const int C = 2 * D + F, S = L.S, DP = D | 1;
  float* WB = WIDE ? ws + (size_t)blockIdx.x * L.ws : base;  // x3, the row buffer, h1
  float* X = WB + L.x3;
  float* Y = base + L.yt;
  float* w0T = WIDE ? nullptr : base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = WIDE ? nullptr : base + L.b0;
  float* lw = base + L.lw;
  const float* b1s = WIDE ? b1 : base + L.b1;
  const float* affs = WIDE ? aff : base + L.aff;  // [scale1; shift1; scale2; shift2] x [D]
  float* nms = base + L.nm;
  float* A = WB + L.ab;  // [W][DP]: rT, then agg, then y
  float* HW = WB + L.hw;
  uint8_t* kps = reinterpret_cast<uint8_t*>(base + L.kp);
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  const int r = blockIdx.x, t = threadIdx.x;
  const int ng = t >> 3, dg = t & 7;  // node block; unit group / output column group
  const bool node_ok = 4 * ng < W;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  const W1Src w1src{w1s, w1, S, H1, p.w1g != 0};
  const uint8_t* kg = mode != kNoDrop ? keep + row0 * C : nullptr;
  const bool kstaged = kg != nullptr && p.pf && reinterpret_cast<uintptr_t>(kg) % 16 == 0;

  // ---- staging, issued together, waited on once (wide: the rows into the
  // workspace)
  if constexpr (WIDE) {
    stage_rowsT<true>(y1 + row0 * D, W, D, X, 0);
    stage_rowsT<true>(y2 + row0 * D, W, D, X, D);
    stage_rowsT<true>(feats + row0 * F, W, F, X, 2 * D);
    if (rT != nullptr)
      for (int i = t; i < W * D; i += kTileThreads) A[(i / D) * DP + i % D] = rT[row0 * D + i];
  } else {
    stage_tile_weights(w0_aug, C + 1, w0_aug + C, C + 1, w1, b1, C, D, H1, S, w0T, w1s, b0s,
                       base + L.b1);
    for (int i = t; i < 4 * D; i += kTileThreads) cp_async4(base + L.aff + i, aff + i);
    stage_rowsT(y1 + row0 * D, W, D, X, 0);      // x3 rows [0, D): y1, then s
    stage_rowsT(y2 + row0 * D, W, D, X, D);      // rows [D, 2D): y2, then agg
    stage_rowsT(feats + row0 * F, W, F, X, 2 * D);
    if (rT != nullptr)
      for (int i = t; i < W * D; i += kTileThreads)
        cp_async4(A + (i / D) * DP + i % D, rT + row0 * D + i);
  }
  cp_rows(nms, nm + row0, W);
  if (kstaged)  // W * C is a multiple of 32
    for (int i = 16 * t; i < W * C; i += 16 * kTileThreads)
      cp_async16(reinterpret_cast<float*>(kps + i), reinterpret_cast<const float*>(kg + i));
  if (p.E > 0) build_col_lists(adj, W, p.E, lw, idx, cnt, reinterpret_cast<uint8_t*>(Y));
  cp_async_wait_all();
  __syncthreads();
  const uint8_t* kp = kstaged ? kps : kg;

  // ---- s and s_old through the affines (multiply, then add, as the plain
  // version rounds them), the movement test one thread a node, d ascending
  if (t < W) {  // W <= 128 threads
    float dist2 = 0.0f, norm2 = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float s = __fadd_rn(__fmul_rn(X[d * W + t], affs[d]), affs[D + d]);
      const float so = __fadd_rn(__fmul_rn(X[(D + d) * W + t], affs[2 * D + d]), affs[3 * D + d]);
      X[d * W + t] = s;
      const float diff = __fsub_rn(s, so);
      dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
      norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
    }
    marg[row0 + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[t] : 0.0f;
  }
  __syncthreads();  // X rows [0, D) hold s; y2 is read

  // ---- agg = adjT^T @ s (+ rT) into x3 rows [D, 2D) and the row buffer
  for (int i = t; i < W * D; i += kTileThreads) {
    const int n = i % W, d = i / W;
    float a = line_dot(adj, W, n, true, p.E, lw, idx, cnt, X + d * W);
    if (rT != nullptr) a += A[n * DP + d];
    A[n * DP + d] = a;
    X[(D + d) * W + n] = a;
  }
  __syncthreads();

  // ---- agg out (before the dropout), x3 dropped in place
  for (int i = t; i < W * D; i += kTileThreads) agg[row0 * D + i] = A[(i / D) * DP + i % D];
  if (mode != kNoDrop)
    for (int i = t; i < C * W; i += kTileThreads) {
      const int c = i / W, n = i % W;
      X[i] = drop(mode, da, db, X[i], kp[n * C + c] != 0);
    }
  __syncthreads();

  // ---- h1 = w1 @ act0(w0 @ x3 + b0) + b1 on the register tiles
  float h1[4][DG];
  if constexpr (!WIDE) h1_bias<DG>(h1, b1s, dg, D);
  const int nch = (S + CH - 1) / CH;
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * CH, jc = min(CH, S - j0);
    float* Yb = Y + (p.nbuf == 2 ? (ci & 1) : 0) * CH * W;
    if (node_ok && UT * dg < jc) {
      float a[4][UT];
      if constexpr (WIDE)
        first_product3(X, W, D, C, W0Dev{w0_aug, w0_aug + C, C + 1, C + 1, H1, j0 + UT * dg},
                       ng, a);
      else
        first_product3(X, W, D, C, w0T + j0 + UT * dg, S, b0s + j0 + UT * dg, ng, a);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < UT; ++u) a[n][u] = activate(act0, a[n][u]);
      store_tile<UT>(Yb, UT * dg, ng, W, a);
    }
    __syncthreads();  // the chunk's y0 tile is full
    if constexpr (WIDE) {
      for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
        if (ci == 0)
          h1_bias<DG>(h1, b1s, d0 + dg, D);
        else
          tile_io<false>(h1, HW, W, ng, d0 + dg, D);
        second_product<UT, DG>(Yb, W, w1src, j0, jc, ng, d0 + dg, D, h1);
        tile_io<true>(h1, HW, W, ng, d0 + dg, D);
      }
    } else if (node_ok) {
      second_product<UT, DG>(Yb, W, w1src, j0, jc, ng, dg, D, h1);
    }
    // two tiles: the next chunk writes the other one, whose readers are past
    // the barrier above
    if (p.nbuf == 1) __syncthreads();
  }

  // ---- y = act1(h1) into the row buffer (agg is out: past the barriers),
  // outputs d0 + dg + 8 i
  auto finish = [&](int d0) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int d = d0 + dg + 8 * i;
        if (d < D) A[(4 * ng + n) * DP + d] = activate(act1, h1[n][i]);
      }
  };
  if constexpr (WIDE) {
    for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
      tile_io<false>(h1, HW, W, ng, d0 + dg, D);
      finish(d0);
    }
  } else if (node_ok) {
    finish(0);
  }
  __syncthreads();  // every thread is past its reads of the y0 tiles

  // ---- y out; msum, a thread a column summing the block's nodes in order
  for (int i = t; i < W * D; i += kTileThreads) y[row0 * D + i] = A[(i / D) * DP + i % D];
  for (int d = t; d < D; d += kTileThreads) {
    float s = 0.0f;
    for (int n = 0; n < W; ++n) s = fmaf(A[n * DP + d], nms[n], s);
    msum[(size_t)r * D + d] = s;
  }
}

using Bn2FwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const uint8_t*, const float*, const float*, const float*, const float*,
                          const float*, const float*, float*, float*, float*, float*, int, int,
                          int, int, int, float, int, int, int, float, float, Tile2Plan, float*);

// K14's kernel and plan for a shape: the first plan of kBn2FwdPlans that
// fits, else the wide plan (index 2), or plan g_force (>= 0) if it fits;
// nullptr if none. *ws: the plan's workspace floats a block row.
Bn2FwdFn pick_fwd(int W, int D, int F, int H1, Tile2Plan* p, size_t* bytes, int* index,
                  int* ws) {
  if (!pick_plan(kBnForward2, kBn2FwdPlans, W, D, F, H1, p, bytes, index, g_force, ws))
    return nullptr;
  if (*ws > 0) return bn2_fwd_tile_kernel<64, true>;
  switch (width_class(D > F ? D : F)) {
    case 16:
      return bn2_fwd_tile_kernel<16, false>;
    case 32:
      return bn2_fwd_tile_kernel<32, false>;
    default:
      return bn2_fwd_tile_kernel<64, false>;
  }
}

bool shape_ok(int R, int Bl, int W, int D, int F, int H1) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && H1 > 0;
}

}  // namespace

extern "C" {

// adj_loop [Bl, W, W] (null when Bl == 0), adj_dep [R - Bl, W, W] (null when
// Bl == R); y1, y2, rT (nullable) [R, W, D]; aff [2, 2, D]; keep uint8
// [R, W, 2D + F] (null when mode == 0); feats [R, W, F]; w0_aug
// [H1, 2D + F + 1]; w1 [D, H1]; b1 [D]; nm [R, W] -> y, agg [R, W, D],
// marg [R, W], msum [R, D]; ws: the wide plan's workspace, R slices of
// gnn_bn2_forward_workspace floats (null for a staged plan). Returns a
// cudaError_t code.
int gnn_bn2_forward(const float* adj_loop, const float* adj_dep, const float* y1,
                    const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                    const float* feats, const float* w0_aug, const float* w1, const float* b1,
                    const float* nm, float* y, float* agg, float* marg, float* msum, int R,
                    int Bl, int W, int D, int F, int H1, float thr, int act0, int act1, int mode,
                    float da, float db, void* stream, float* ws) {
  if (!shape_ok(R, Bl, W, D, F, H1)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Bn2FwdFn fn = pick_fwd(W, D, F, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm, y, agg, marg, msum,
      Bl, W, D, F, H1, thr, act0, act1, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block row the plan gnn_bn2_forward picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_bn2_forward_workspace(int W, int D, int F, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick_fwd(W, D, F, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bn2_forward launches for
// this shape. Returns a cudaError_t code.
int gnn_bn2_forward_info(int W, int D, int F, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Bn2FwdFn fn = pick_fwd(W, D, F, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kBn2FwdPlans (2: the wide plan) from now on, where
// it fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_bn2_forward_force_plan(int index) { g_force = index; }

}  // extern "C"
