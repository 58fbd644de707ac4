// K13, the reverse of the two-layer dropout-training loop, for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16), as
// register-tiled block products.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K13 _loop2_train_bwd_kernel (launched by _loop2_train_bwd_impl) -> gnn_train_loop2_bwd
//
// The K reverse iterations of K12 (fused2.cu) on one W-node block; reverse
// step k, from the saved state traj[k-1] (s0) and pre-dropout aggregation agg[k]:
//   x3  = [drop(s, ms) | drop(agg, ma) | fd[k]],  h0 = w0 @ x3 + b0,
//   y0  = act0(h0),  h1 = w1 @ y0 + b1            recomputed
//   dh1 = (g_traj[k] + gs) * act1'(h1)            -> db1, dw1 += dh1 (x) y0
//   dh0 = (w1^T @ dh1) * act0'(h0)                -> db0, dw0 += dh0 (x) x3
//   dx3 = w0^T @ dh0                              -> dfd[k] = dx3[2D:]
//   gs  = dx3[:D] * a*ms + adjT @ (dx3[D:2D] * a*ma)
//
// Bound: the function needs 2*H1*(9D + 3AL + 1) flops a node and reverse step
// (41 kflop on the hidden-150 recipe, W = 128, D = 14, AL = 3, H1 = 150: the
// forward recomputed once, the reverse dense layers, the weight sums) and the
// block's arcs 2*D each, against about 14*D + 8*AL bytes a node and step: the
// least time is the operations at the card's 67 TFLOP/s fp32
// (chip_smoke.py::two_layer_bounds: 0.446 ms on the training batch's 1104 loop
// rows, K = 5).
//
// Design (tile2.cuh's building blocks), one CTA of 256 threads a block, two
// passes over 32-unit chunks of the hidden layer a reverse step
// (tile2.cuh::reverse_pass1, reverse_pass2, the device code K11 and K15 share):
// - pass 1 forms h0 on 4-node x 4-unit register tiles (x3 @ w0^T, 16 FMAs a
//   pair of 16-byte reads), keeps it in a [S][W] block in shared memory and
//   forms h1 += y0 @ w1^T as K10 does. h0 is computed once a reverse step
//   (forming it again for the reverse pass would cost 2*H1*(11D + 4AL + 1)
//   flops a node): the dense flops are 2*H1*(9D + 3AL) plus the padding of
//   the hidden width (S = 156 units for H1 = 150);
// - dh1 = (g + gs) * act1'(h1) on the owner threads of h1, into shared memory;
// - pass 2, a chunk at a time: dy0 = dh1 @ w1 on the same tiles, dh0 =
//   dy0 * act0'(h0) (h0 read back, y0 = act0(h0) beside it); then the
//   chunk's weight sums as block products over the block's nodes, each thread
//   owning 4 units x 4 columns of [x3 | 1] or of dh1 (dw0, db0 through a
//   column of ones, dw1), 8 16-byte reads a 64 FMAs, two threads a quad
//   (half of the nodes each) where that fits; then dx3 += dh0 @ w0 on
//   4-node x C/8-column register tiles, held across the chunks;
// - each thread owns a fixed set of the dw0/db0/dw1/db1 entries (6,914 at the
//   recipe) for the whole launch: they are summed in shared memory and the
//   block's partial is written to device memory once a launch (summing them
//   there would read, add to and write back ~30 MB every reverse step);
// - the next step's rows (traj[k-2] or s0, agg[k-1], fd[k-1], g_traj[k-1])
//   are prefetched with cp.async while a step computes; the weights are
//   staged once with cp.async;
// - the gs contraction reads each source row's nonzero entries from a compact
//   list built once a launch ([16][W] weights and uint8 destinations); a row
//   with more than 16 arcs is read from device memory, every entry, so a
//   dense block is exact.
// No atomics: every sum runs in a fixed order and each partial entry belongs
// to one thread, so a second launch is bit-identical; torch sums the
// per-block partials in a fixed order. Padded rows (zero cotangents) add
// exactly 0. At the recipe a CTA takes 209.1 KB: one CTA, 8 warps, an SM.
// Shapes whose layout does not fit take a leaner plan (tile2.cuh
// kTrain2Plans): without the prefetch; then with h0 recomputed in pass 2 and
// the partials summed in device memory; last, without the lists, 2 units a
// thread and w1 read from device memory, which fits every shape the per-node
// kernel that this replaces took.
// The wide plan (tile2.cuh kTile2Wide, index 4, chosen only where no plan of
// kTrain2Plans fits) takes every D, AL and H1: x3, G, h1 and dx3 lie in a
// workspace slice a block (gnn_train_loop2_bwd_workspace floats, allocated by
// the wrapper), the weights and biases are read from device memory, and h1
// and dx3 go through the 64-wide register tiles a chunk at a time
// (reverse_pass1/2's WIDE): the same chains, so a forced wide plan gives the
// staged plans' bits. Its one instantiation is compiled from
// train_loop2_bwd_wide.cu (this file under GNN_WIDE_TU), and the staged
// plans' at register width 64 from train_loop2_bwd_64.cu (under
// GNN_MAXF64_TU), beside this file's.

#include "tile2.cuh"

namespace {

using namespace gnn;

int g_force = -1;  // gnn_train_loop2_bwd_force_plan

template <int MAXF, int UT, bool WIDE>
__global__ void __launch_bounds__(kTileThreads, 1)
train2_bwd_tile_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                       const float* __restrict__ traj, const float* __restrict__ agg,
                       const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                       const float* __restrict__ fd, const float* __restrict__ w0,
                       const float* __restrict__ b0, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ g_traj,
                       float* __restrict__ gs_out, float* __restrict__ dw0_out,
                       float* __restrict__ db0_out, float* __restrict__ dw1_out,
                       float* __restrict__ db1_out, float* __restrict__ dfd, int B, int W, int D,
                       int AL, int H1, int K, int act0, int act1, int mode, float da, float db,
                       Tile2Plan p, float* ws) {
  constexpr int DG = MAXF / 8, CT = 3 * MAXF / 8;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kReverse2, W, D, AL, H1, p, WIDE);
  const int C = 2 * D + AL, S = L.S;
  float* WB = WIDE ? ws + (size_t)blockIdx.x * L.ws : base;  // x3, G, h1, dx3
  float* X = WB + L.x3;     // x3, then the dagg rows [0, D)
  float* G = WB + L.dh1;    // g + gs, then dh1, then the new gs
  float* Y = base + L.yt;   // y0 of a chunk
  float* H = base + L.ht;   // h0, then dh0 (rows j, or j - j0 without keep)
  float* w0T = WIDE ? nullptr : base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = WIDE ? nullptr : base + L.b0;
  float* PF = base + L.pf;
  float* lw = base + L.lw;
  float* DW = base + L.dw;  // [H1][C + 1] dw0 | db0, [D][H1] dw1, [D] db1
  const float* b1s = WIDE ? b1 : base + L.b1;
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  const int b = blockIdx.x, t = threadIdx.x;
  const int ng = t >> 3, jg = t & 7;  // node block; unit group / column group
  const bool node_ok = 4 * ng < W;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  const W1Src w1src{w1s, w1, S, H1, p.w1g != 0};
  float* DW1 = DW + H1 * (C + 1);
  float* DB1 = DW1 + D * H1;

  // step k's rows: s_in [W][D], agg [W][D], fd [W][AL], g [W][D]
  auto rows = [&](int k, int which) -> const float* {
    const size_t kb = (size_t)k * B + b;
    switch (which) {
      case 0:
        return k > 0 ? traj + ((size_t)(k - 1) * B + b) * W * D : s0 + row0 * D;
      case 1:
        return agg + kb * W * D;
      case 2:
        return fd + kb * W * AL;
      default:
        return g_traj + kb * W * D;
    }
  };
  auto prefetch = [&](int k) {
    cp_rows(PF, rows(k, 0), W * D);
    cp_rows(PF + W * D, rows(k, 1), W * D);
    cp_rows(PF + 2 * W * D, rows(k, 2), W * AL);
    cp_rows(PF + 2 * W * D + W * AL, rows(k, 3), W * D);
  };

  if constexpr (!WIDE)
    stage_tile_weights(w0, C, b0, 1, w1, b1, C, D, H1, S, w0T, w1s, b0s, base + L.b1);
  if (p.E > 0 && t < W) build_list(adj, W, t, p.E, false, lw, idx, cnt);
  if (p.dw)
    for (int i = t; i < H1 * (C + 1) + D * H1 + D; i += kTileThreads) DW[i] = 0.0f;
  for (int i = t; i < D * W; i += kTileThreads) G[i] = 0.0f;
  if (p.pf) prefetch(K - 1);
  cp_async_wait_all();
  __syncthreads();

  const Tile2Rev rev{X, G, Y, H, w0T, b0s, b1s, w1src, W, C, D, H1, S, p.keep, p.nbuf,
                     W0Dev{w0, b0, C, 1, H1, 0}, WB + L.hw, WB + L.dx};
  for (int k = K - 1; k >= 0; --k) {
    const size_t kb = (size_t)k * B + b;
    const bool first = k == K - 1;
    const uint8_t* ks = mode != kNoDrop ? ms + kb * W * D : nullptr;
    const uint8_t* ka = mode != kNoDrop ? ma + kb * W * D : nullptr;
    // x3 as K12 formed it, transposed into X; G = g_traj[k] + gs
    {
      const float* rs = p.pf ? PF : rows(k, 0);
      const float* ra = p.pf ? PF + W * D : rows(k, 1);
      const float* rf = p.pf ? PF + 2 * W * D : rows(k, 2);
      const float* rg = p.pf ? PF + 2 * W * D + W * AL : rows(k, 3);
      // consecutive threads take consecutive nodes: conflict-free stores
      for (int i = t; i < W * D; i += kTileThreads) {
        const int d = i / W, n = i % W, r = n * D + d;
        X[i] = drop(mode, da, db, rs[r], ks != nullptr && ks[r] != 0);
        X[D * W + i] = drop(mode, da, db, ra[r], ka != nullptr && ka[r] != 0);
        G[i] += rg[r];
      }
      for (int i = t; i < W * AL; i += kTileThreads)
        X[2 * D * W + i] = rf[(i % W) * AL + i / W];
    }
    __syncthreads();  // X and G are full; the prefetch buffer is free
    if (p.pf && k > 0) prefetch(k - 1);

    // pass 1: h0 (kept), y0, h1 = w1 @ y0 + b1
    float h1[4][DG];
    reverse_pass1<UT, DG, WIDE>(rev, act0, ng, jg, h1);
    // dh1 = (g + gs) * act1'(h1) into G (each entry read and written by its
    // owner), outputs d0 + jg + 8 i
    auto form_dh1 = [&](int d0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int d = d0 + jg + 8 * i;
          if (d < D) G[d * W + 4 * ng + n] *= act_grad(act1, h1[n][i]);
        }
    };
    if constexpr (WIDE) {
      for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
        tile_io<false>(h1, rev.HW, W, ng, d0 + jg, D);
        form_dh1(d0);
      }
    } else if (node_ok) {
      form_dh1(0);
    }
    __syncthreads();  // G holds every node's dh1

    // pass 2: db1, then dh0, the weight sums and dx3, a chunk at a time
    const Tile2Parts parts =
        Tile2Parts{p.dw ? DW : nullptr, dw0_out + (size_t)b * H1 * C, db0_out + (size_t)b * H1,
                   dw1_out + (size_t)b * D * H1, db1_out + (size_t)b * D, C, 1, !first};
    float dx[4][CT];
    reverse_pass2<UT, CT, WIDE>(rev, parts, act0, ng, jg, dx);

    // dfd[k] = dx3[2D:]; dagg = dx3[D:2D] * a*ma into X rows [0, D) (every
    // reader of x3 is past the last chunk's barrier); dx3[:D] * a*ms kept;
    // columns c0 + jg + 8 i (wide: dx3 a chunk at a time from DX, the kept
    // columns parked again)
    auto route = [&](int c0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int node = 4 * ng + n;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = c0 + jg + 8 * i;
          if (c < D)
            dx[n][i] *= drop_grad(mode, da, ks != nullptr && ks[node * D + c] != 0);
          else if (c < 2 * D)
            X[(c - D) * W + node] =
                dx[n][i] * drop_grad(mode, da, ka != nullptr && ka[node * D + c - D] != 0);
          else if (c < C)
            dfd[(kb * W + node) * AL + c - 2 * D] = dx[n][i];
        }
      }
    };
    // gs[t] = dx3[:D] * a*ms + sum_dst adjT[t][dst] * dagg[dst], into G
    auto contract = [&](int c0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int node = 4 * ng + n;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = c0 + jg + 8 * i;
          if (c < D)
            G[c * W + node] =
                dx[n][i] + line_dot(adj, W, node, false, p.E, lw, idx, cnt, X + c * W);
        }
      }
    };
    if constexpr (WIDE) {
      for (int c0 = 0; node_ok && c0 < C; c0 += kWideCols) {
        tile_io<false>(dx, rev.DX, W, ng, c0 + jg, C);
        route(c0);
        tile_io<true>(dx, rev.DX, W, ng, c0 + jg, C);
      }
    } else if (node_ok) {
      route(0);
    }
    __syncthreads();  // X holds every node's dagg
    if constexpr (WIDE) {
      for (int c0 = 0; node_ok && c0 < D; c0 += kWideCols) {
        tile_io<false>(dx, rev.DX, W, ng, c0 + jg, C);
        contract(c0);
      }
    } else if (node_ok) {
      contract(0);
    }
    if (p.pf) cp_async_wait_all();
    __syncthreads();  // G holds gs; X is rewritten by the next step
  }

  for (int i = t; i < W * D; i += kTileThreads) gs_out[row0 * D + i] = G[(i % D) * W + i / D];
  if (p.dw) {
    for (int i = t; i < H1 * C; i += kTileThreads)
      dw0_out[(size_t)b * H1 * C + i] = DW[(i / C) * (C + 1) + i % C];
    for (int j = t; j < H1; j += kTileThreads) db0_out[(size_t)b * H1 + j] = DW[j * (C + 1) + C];
    for (int i = t; i < D * H1; i += kTileThreads) dw1_out[(size_t)b * D * H1 + i] = DW1[i];
    for (int d = t; d < D; d += kTileThreads) db1_out[(size_t)b * D + d] = DB1[d];
  }
}

using Train2Fn = void (*)(const float*, const float*, const float*, const float*, const uint8_t*,
                          const uint8_t*, const float*, const float*, const float*, const float*,
                          const float*, const float*, float*, float*, float*, float*, float*,
                          float*, int, int, int, int, int, int, int, int, int, float, float,
                          Tile2Plan, float*);

template <int MAXF>
Train2Fn pick_ut(int ut) {
  return ut == 4 ? train2_bwd_tile_kernel<MAXF, 4, false> : train2_bwd_tile_kernel<MAXF, 2, false>;
}

}  // namespace

#if defined(GNN_WIDE_TU)

namespace gnn {
// K13's wide-plan instantiation (train_loop2_bwd_wide.cu).
Train2Fn train2_bwd_wide() { return train2_bwd_tile_kernel<64, 4, true>; }
}  // namespace gnn

#elif defined(GNN_MAXF64_TU)

namespace gnn {
// K13's staged instantiations at register width 64 (train_loop2_bwd_64.cu).
Train2Fn train2_bwd_ut64(int ut) { return pick_ut<64>(ut); }
}  // namespace gnn

#else

namespace gnn {
Train2Fn train2_bwd_wide();
Train2Fn train2_bwd_ut64(int ut);
}  // namespace gnn

namespace {

// The kernel and plan for a shape: the first plan of kTrain2Plans that fits,
// else the wide plan (index 4), or plan g_force (>= 0) if it fits; nullptr if
// none. *ws: the plan's workspace floats a block.
Train2Fn pick(int W, int D, int AL, int H1, Tile2Plan* p, size_t* bytes, int* index, int* ws) {
  if (!pick_plan(kReverse2, kTrain2Plans, W, D, AL, H1, p, bytes, index, g_force, ws))
    return nullptr;
  if (*ws > 0) return train2_bwd_wide();
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return pick_ut<16>(p->ut);
    case 32:
      return pick_ut<32>(p->ut);
    default:
      return train2_bwd_ut64(p->ut);
  }
}

}  // namespace

extern "C" {

// As gnn_train_loop2, plus traj, agg, g_traj [K, B, W, D] -> gs [B, W, D] and
// the per-block partials dw0 [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1],
// db1 [B, D], and dfd [K, B, W, AL]; ws: the wide plan's workspace, B slices
// of gnn_train_loop2_bwd_workspace floats (null for a staged plan). Returns a
// cudaError_t code.
int gnn_train_loop2_bwd(const float* adjT, const float* s0, const float* traj, const float* agg,
                        const uint8_t* ms, const uint8_t* ma, const float* fd, const float* w0,
                        const float* b0, const float* w1, const float* b1, const float* g_traj,
                        float* gs, float* dw0, float* db0, float* dw1, float* db1, float* dfd,
                        int B, int W, int D, int AL, int H1, int K, int act0, int act1, int mode,
                        float da, float db, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (mode != kNoDrop && (ms == nullptr || ma == nullptr)) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Train2Fn fn = pick(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, gs, dw0, db0, dw1, db1, dfd, B, W,
      D, AL, H1, K, act0, act1, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block the plan gnn_train_loop2_bwd picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_train_loop2_bwd_workspace(int W, int D, int AL, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick(W, D, AL, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_train_loop2_bwd launches
// for this shape. Returns a cudaError_t code.
int gnn_train_loop2_bwd_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Train2Fn fn = pick(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kTrain2Plans (4: the wide plan) from now on, where it
// fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_train_loop2_bwd_force_plan(int index) { g_force = index; }

}  // extern "C"

#endif  // GNN_WIDE_TU, GNN_MAXF64_TU
