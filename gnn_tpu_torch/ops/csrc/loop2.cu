// K10, the two-layer eval loop, and K12, the two-layer dropout-training
// loop, for Hopper (sm_90a), in plain fp32 on the CUDA cores (no TF32, no
// bf16), as register-tiled block products: one kernel, K12 its TRAIN
// instantiation.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K10 _loop2_kernel_T       (launched by _loop2_impl)       -> gnn_propagation_loop2
//   K12 _loop2_train_kernel_T (launched by _loop2_train_impl) -> gnn_train_loop2
// K12's reverse, K13, is in train_loop2_bwd.cu.
//
// K10: all K eval iterations of a residual-free W-node block, f the raw
// arc-label aggregation (the same every iteration), (scale, shift) the
// inference BatchNorm; iteration k on the state s (traj[k - 1], or s0):
//   marg[k] = nm where ||s - s_old|| > thr ||s_old|| (s_old: the state before
//             s, ones at k = 0), else 0
//   agg     = adjT^T @ s
//   s'      = act1(w1 @ act0(w0 @ [s | agg | f] + b0) + b1) * scale + shift
//   traj[k] = s'
// K12: the same iterations in training, with no affine: x3 = [drop(s) |
// drop(agg) | fd[k]] from the uint8 keep-masks ms[k], ma[k] and the dropped
// arc-label aggregation fd[k] of iteration k; agg[k], before the dropout, is
// written out (K13 reads it). The movement test reads the undropped state.
//
// Bound: the dense layers cost 2*H1*(3D + AL) flops a node and iteration
// (13.5 kflop on the hidden-150 recipe, W = 128, D = 14, AL = 3, H1 = 150)
// and the block's arcs 2*D each, against 4*D + 4 bytes written a node and
// iteration (K12: also 4*D of agg, 2*D mask and 4*AL fd bytes): the least
// time is the operations at the card's 67 TFLOP/s fp32
// (chip_smoke.py::two_layer_bounds: K10 0.196 ms on the serving batch's 1440
// loop rows, K = 5; K12 0.151 ms on the training batch's 1104).
//
// Design (tile2.cuh's building blocks), one CTA of 256 threads a block:
// - the dense layers are block products on register tiles: thread t owns 4
//   nodes x 4 hidden units of a 32-unit chunk for h0 = x3 @ w0^T + b0 (act0
//   on the tile, y0 into a swizzled [32][W] tile, double-buffered) and 4
//   nodes x D/8 outputs of h1 += y0 @ w1^T, held in registers across the
//   chunks. Every operand read is a 16-byte shared-memory read feeding 16
//   FMAs (h0) or 4 + 4 per output column (h1), not one scalar weight read a
//   FMA at the odd stride C = 31;
// - the adjacency is not kept: at staging each destination's nonzero
//   entries (the block is ~1.6% dense, ~2 arcs a node) go into a compact
//   list in shared memory ([16][W] weights and uint8 sources); a destination
//   with more than 16 in-arcs reads its column of the adjacency from device
//   memory (every entry, so a dense block is exact). agg costs 2*D a arc, not
//   2*D*W a node;
// - the weights, the biases and the block's rows are staged once a launch
//   with cp.async; at the recipe a CTA takes 87.9 KB (a resident adjacency
//   alone is 66 KB), so two CTAs of 256 threads, 16 warps, fit an SM;
// - the movement test is summed over each node's D/8 owner threads into
//   shared memory and finished by one thread a node, with no atomics.
// - K12: the owner thread of (node, output column) keeps that node's
//   undropped state in registers (4 nodes x D/8 values), so x3's state rows
//   can take the dropped copy; after the aggregation it writes agg[k] and the
//   dropped agg and state into x3, from keep bits it loaded at the start of
//   the iteration; fd[k] is copied into x3's last AL rows with cp.async while
//   the aggregation runs.
// Shapes whose layout does not fit take the leaner plan (tile2.cuh
// kLoop2Plans, kTrainLoop2Plans: one y0 tile, no lists, w1 read from device
// memory), which fits every shape the per-node kernels that these replace
// took. The wide plan (tile2.cuh kTile2Wide, chosen only where neither
// fits) takes every D, AL and H1: x3, h1 and K12's undropped state lie in a
// workspace slice a block (gnn_propagation_loop2_workspace /
// gnn_train_loop2_workspace floats, allocated by the wrapper), the weights,
// the biases and the affine are read from device memory, and a thread's
// outputs go through its 64-wide tiles a chunk at a time, the keep bytes read
// where they are used: the same chains, so a forced wide plan gives the
// staged plans' bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

static_assert(kLoop2Plans[0].ut == 4 && kLoop2Plans[1].ut == 4, "K10 owns 4 units a thread");
static_assert(kTrainLoop2Plans[0].ut == 4 && kTrainLoop2Plans[1].ut == 4,
              "K12 owns 4 units a thread");

int g_force = -1;       // gnn_train_loop2_force_plan
int g_force_eval = -1;  // gnn_propagation_loop2_force_plan

// TRAIN false: K10 (f [B, W, AL], aff; ms, ma, agg_out unused); TRAIN true:
// K12 (f = fd [K, B, W, AL], the keep-masks ms/ma [K, B, W, D] (null when
// mode == kNoDrop), agg_out [K, B, W, D]; aff unused). WIDE: the wide plan
// (ws its workspace).
template <int MAXF, bool TRAIN, bool WIDE>
__global__ void __launch_bounds__(kTileThreads, 2)
loop2_tile_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                  const float* __restrict__ f, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ aff,
                  const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                  const float* __restrict__ nm, float* __restrict__ traj,
                  float* __restrict__ marg, float* __restrict__ agg_out, int B, int W, int D,
                  int AL, int H1, int K, float thr, int act0, int act1, int mode, float da,
                  float db, Tile2Plan p, float* ws) {
  constexpr int DG = MAXF / 8, UT = 4, CH = 8 * UT;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kForward2, W, D, AL, H1, p, WIDE);
  const int C = 2 * D + AL, S = L.S;
  float* WB = WIDE ? ws + (size_t)blockIdx.x * L.ws : base;  // x3, h1, K12's state
  float* X = WB + L.x3;
  float* Y = base + L.yt;
  float* w0T = WIDE ? nullptr : base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = WIDE ? nullptr : base + L.b0;
  float* lw = base + L.lw;
  const float* b1s = WIDE ? b1 : base + L.b1;
  const float* affs = WIDE ? aff : base + L.aff;
  float* HW = WB + L.hw;
  float* SV = WB + L.sv;  // wide K12: the undropped state [D][W]
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  const int b = blockIdx.x, t = threadIdx.x;
  const int ng = t >> 3, dg = t & 7;  // node block; unit group / output column group
  const bool node_ok = 4 * ng < W;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  const W1Src w1src{w1s, w1, S, H1, p.w1g != 0};

  if constexpr (WIDE) {
    stage_rowsT<true>(s0 + row0 * D, W, D, X, 0);
    if constexpr (!TRAIN) stage_rowsT<true>(f + row0 * AL, W, AL, X, 2 * D);
  } else {
    stage_tile_weights(w0, C, b0, 1, w1, b1, C, D, H1, S, w0T, w1s, b0s, base + L.b1);
    if constexpr (!TRAIN) {
      for (int i = t; i < 2 * D; i += kTileThreads) cp_async4(base + L.aff + i, aff + i);
    }
    stage_rowsT(s0 + row0 * D, W, D, X, 0);
    if constexpr (!TRAIN) stage_rowsT(f + row0 * AL, W, AL, X, 2 * D);
  }
  if (p.E > 0 && t < W) build_list(adj, W, t, p.E, true, lw, idx, cnt);
  cp_async_wait_all();
  __syncthreads();

  // Per-node movement sums of the owner threads, [8][W][2] over the first Y tile.
  float* red = Y;
  float dist[4], norm[4];
  auto flush_movement = [&](int k) {
    if (node_ok)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        red[2 * (dg * W + 4 * ng + n)] = dist[n];
        red[2 * (dg * W + 4 * ng + n) + 1] = norm[n];
      }
    __syncthreads();
    if (t < W) {
      float d2 = 0.0f, n2 = 0.0f;
      for (int g = 0; g < 8; ++g) {
        d2 = __fadd_rn(d2, red[2 * (g * W + t)]);
        n2 = __fadd_rn(n2, red[2 * (g * W + t) + 1]);
      }
      marg[((size_t)k * B + b) * W + t] = sqrtf(d2) > thr * sqrtf(n2) ? nm[row0 + t] : 0.0f;
    }
  };
  // K12: the owner's undropped state, sv[n][i] of node 4 ng + n, column dg + 8 i
  // (wide: SV [D][W], each entry its owner's)
  float sv[4][DG];
  if constexpr (TRAIN && WIDE) {
    for (int d = dg; node_ok && d < D; d += 8)
#pragma unroll
      for (int n = 0; n < 4; ++n) SV[d * W + 4 * ng + n] = X[d * W + 4 * ng + n];
  } else if constexpr (TRAIN) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int d = dg + 8 * i;
        sv[n][i] = node_ok && d < D ? X[d * W + 4 * ng + n] : 0.0f;
      }
    }
  }
  // before update 0 the old state is ones
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    dist[n] = norm[n] = 0.0f;
    if constexpr (WIDE) {
      for (int d = dg; node_ok && d < D; d += 8) {
        const float diff = X[d * W + 4 * ng + n] - 1.0f;
        dist[n] = __fadd_rn(dist[n], __fmul_rn(diff, diff));
        norm[n] = __fadd_rn(norm[n], 1.0f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int d = dg + 8 * i;
        if (node_ok && d < D) {
          const float diff = X[d * W + 4 * ng + n] - 1.0f;
          dist[n] = __fadd_rn(dist[n], __fmul_rn(diff, diff));
          norm[n] = __fadd_rn(norm[n], 1.0f);
        }
      }
    }
  }
  flush_movement(0);

  const int nch = (S + CH - 1) / CH;
  for (int k = 0; k < K; ++k) {
    const size_t kb = (size_t)k * B + b;
    // K12: fd[k] into X rows [2D, 2D + AL) (no thread reads them until the
    // chunks) and this iteration's keep bits, bit n * DG + i of node 4 ng + n,
    // column dg + 8 i, while the aggregation runs
    uint32_t kept_s = 0, kept_a = 0;
    if constexpr (TRAIN && WIDE) {
      stage_rowsT<true>(f + kb * W * AL, W, AL, X, 2 * D);
    } else if constexpr (TRAIN) {
      stage_rowsT(f + kb * W * AL, W, AL, X, 2 * D);
      if (mode != kNoDrop && node_ok) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int i = 0; i < DG; ++i) {
            const int d = dg + 8 * i;
            if (d < D) {
              const size_t e = (kb * W + 4 * ng + n) * D + d;
              kept_s |= (ms[e] != 0 ? 1u : 0u) << (n * DG + i);
              kept_a |= (ma[e] != 0 ? 1u : 0u) << (n * DG + i);
            }
          }
        }
      }
    }
    // agg = adjT^T @ s into X rows [D, 2D): thread (node, half of the columns)
    {
      const int n = t & (kMaxW - 1);
      if (n < W)
        for (int d = t >> 7; d < D; d += 2)
          X[(D + d) * W + n] = line_dot(adj, W, n, true, p.E, lw, idx, cnt, X + d * W);
    }
    __syncthreads();  // X holds x3 (K12: undropped); the movement sums are read
    if constexpr (TRAIN && WIDE) {
      // as below, the keep bytes read here
      for (int d = dg; node_ok && d < D; d += 8)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int node = 4 * ng + n;
          const size_t e = (kb * W + node) * D + d;
          const bool ks = mode != kNoDrop && ms[e] != 0, ka = mode != kNoDrop && ma[e] != 0;
          const float a = X[(D + d) * W + node];
          agg_out[e] = a;
          X[(D + d) * W + node] = drop(mode, da, db, a, ka);
          X[d * W + node] = drop(mode, da, db, SV[d * W + node], ks);
        }
      __syncthreads();  // X holds the dropped x3 and fd[k]
    } else if constexpr (TRAIN) {
      // agg[k] before the dropout, then the dropped state and aggregation
      // into X rows [0, 2D), each entry by its owner
      if (node_ok) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int node = 4 * ng + n;
#pragma unroll
          for (int i = 0; i < DG; ++i) {
            const int d = dg + 8 * i;
            if (d < D) {
              const float a = X[(D + d) * W + node];
              agg_out[(kb * W + node) * D + d] = a;
              X[(D + d) * W + node] = drop(mode, da, db, a, (kept_a >> (n * DG + i)) & 1u);
              X[d * W + node] = drop(mode, da, db, sv[n][i], (kept_s >> (n * DG + i)) & 1u);
            }
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();  // X holds the dropped x3 and fd[k]
    }

    float h1[4][DG];
    if constexpr (!WIDE) h1_bias<DG>(h1, b1s, dg, D);
    for (int ci = 0; ci < nch; ++ci) {
      const int j0 = ci * CH, jc = min(CH, S - j0);
      float* Yb = Y + (p.nbuf == 2 ? (ci & 1) : 0) * CH * W;
      if (node_ok && UT * dg < jc) {
        float a[4][UT];
        if constexpr (WIDE)
          first_product<UT>(X, W, C, W0Dev{w0, b0, C, 1, H1, j0 + UT * dg}, ng, a);
        else
          first_product<UT>(X, W, C, w0T + j0 + UT * dg, S, b0s + j0 + UT * dg, ng, a);
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

    // s' = act1(h1) * scale + shift (K12: act1(h1)) into X rows [0, D) and
    // traj[k]; every thread is past its reads of X (the last chunk's barrier)
    if constexpr (WIDE) {
#pragma unroll
      for (int n = 0; n < 4; ++n) dist[n] = norm[n] = 0.0f;
      for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
        tile_io<false>(h1, HW, W, ng, d0 + dg, D);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int node = 4 * ng + n;
#pragma unroll
          for (int i = 0; i < DG; ++i) {
            const int d = d0 + dg + 8 * i;
            if (d < D) {
              float y, old;
              if constexpr (TRAIN) {
                y = activate(act1, h1[n][i]);
                old = SV[d * W + node];
                SV[d * W + node] = y;
              } else {
                y = activate(act1, h1[n][i]) * affs[d] + affs[D + d];
                old = X[d * W + node];
              }
              const float diff = y - old;
              dist[n] = __fadd_rn(dist[n], __fmul_rn(diff, diff));
              norm[n] = __fadd_rn(norm[n], __fmul_rn(old, old));
              X[d * W + node] = y;
              traj[(kb * W + node) * D + d] = y;
            }
          }
        }
      }
    } else {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      dist[n] = norm[n] = 0.0f;
      const int node = 4 * ng + n;
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int d = dg + 8 * i;
        if (node_ok && d < D) {
          float y, old;
          if constexpr (TRAIN) {
            y = activate(act1, h1[n][i]);
            old = sv[n][i];
            sv[n][i] = y;
          } else {
            y = activate(act1, h1[n][i]) * affs[d] + affs[D + d];
            old = X[d * W + node];
          }
          const float diff = y - old;
          dist[n] = __fadd_rn(dist[n], __fmul_rn(diff, diff));
          norm[n] = __fadd_rn(norm[n], __fmul_rn(old, old));
          X[d * W + node] = y;
          traj[(kb * W + node) * D + d] = y;
        }
      }
    }
    }
    __syncthreads();  // every thread is past its reads of the y0 tiles
    if (k + 1 < K) flush_movement(k + 1);
  }
}

using Loop2Fn = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, const float*, const float*, const uint8_t*, const uint8_t*,
                         const float*, float*, float*, float*, int, int, int, int, int, int, float,
                         int, int, int, float, float, Tile2Plan, float*);

// The kernel and plan of K10 (TRAIN false) or K12 for a shape (nullptr if
// none fits): the first staged plan that fits, else the wide plan (index 2),
// or the forced plan (g_force_eval, g_force) where it is set. *ws: the plan's
// workspace floats a block.
template <bool TRAIN>
Loop2Fn pick(int W, int D, int AL, int H1, Tile2Plan* p, size_t* bytes, int* index, int* ws) {
  const bool ok = TRAIN ? pick_plan(kForward2, kTrainLoop2Plans, W, D, AL, H1, p, bytes, index,
                                    g_force, ws)
                        : pick_plan(kForward2, kLoop2Plans, W, D, AL, H1, p, bytes, index,
                                    g_force_eval, ws);
  if (!ok) return nullptr;
  if (*ws > 0) return loop2_tile_kernel<64, TRAIN, true>;
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return loop2_tile_kernel<16, TRAIN, false>;
    case 32:
      return loop2_tile_kernel<32, TRAIN, false>;
    default:
      return loop2_tile_kernel<64, TRAIN, false>;
  }
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], f [B, W, AL], w0 [H1, 2D + AL], b0 [H1],
// w1 [D, H1], b1 [D], aff [2, D], nm [B, W] -> traj [K, B, W, D],
// marg [K, B, W]; ws: the wide plan's workspace, B slices of
// gnn_propagation_loop2_workspace floats (null for a staged plan). Returns a
// cudaError_t code.
int gnn_propagation_loop2(const float* adjT, const float* s0, const float* f, const float* w0,
                          const float* b0, const float* w1, const float* b1, const float* aff,
                          const float* nm, float* traj, float* marg, int B, int W, int D, int AL,
                          int H1, int K, float thr, int act0, int act1, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Loop2Fn fn = pick<false>(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, f, w0, b0, w1, b1, aff, nullptr, nullptr, nm, traj, marg, nullptr, B, W, D, AL,
      H1, K, thr, act0, act1, kNoDrop, 1.0f, 0.0f, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block the plan gnn_propagation_loop2 picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_propagation_loop2_workspace(int W, int D, int AL, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick<false>(W, D, AL, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_loop2 launches
// for this shape. Returns a cudaError_t code.
int gnn_propagation_loop2_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Loop2Fn fn = pick<false>(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kLoop2Plans (2: the wide plan) from now on, where
// it fits (a launch at a shape it does not fit fails), or the first plan
// that fits again (index -1): for timing one plan against another.
void gnn_propagation_loop2_force_plan(int index) { g_force_eval = index; }

// adjT [B, W, W], s0 [B, W, D], ms/ma uint8 [K, B, W, D] (null when mode == 0),
// fd [K, B, W, AL], w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D], nm [B, W]
// -> traj, agg [K, B, W, D], marg [K, B, W]; ws as gnn_propagation_loop2's
// (gnn_train_loop2_workspace floats a block). Returns a cudaError_t code.
int gnn_train_loop2(const float* adjT, const float* s0, const uint8_t* ms, const uint8_t* ma,
                    const float* fd, const float* w0, const float* b0, const float* w1,
                    const float* b1, const float* nm, float* traj, float* marg, float* agg, int B,
                    int W, int D, int AL, int H1, int K, float thr, int act0, int act1, int mode,
                    float da, float db, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (mode != kNoDrop && (ms == nullptr || ma == nullptr)) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Loop2Fn fn = pick<true>(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, fd, w0, b0, w1, b1, nullptr, ms, ma, nm, traj, marg, agg, B, W, D, AL, H1, K,
      thr, act0, act1, mode, da, db, p, ws);
  return cudaGetLastError();
}

// As gnn_propagation_loop2_workspace, for gnn_train_loop2.
int gnn_train_loop2_workspace(int W, int D, int AL, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick<true>(W, D, AL, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// As gnn_propagation_loop2_info, for the kernel gnn_train_loop2 launches.
int gnn_train_loop2_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Loop2Fn fn = pick<true>(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kTrainLoop2Plans (2: the wide plan) from now on,
// where it fits (a launch at a shape it does not fit fails), or the first
// plan that fits again (index -1): for timing one plan against another.
void gnn_train_loop2_force_plan(int index) { g_force = index; }

}  // extern "C"
