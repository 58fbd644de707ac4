// K11, the reverse of the two-layer eval loop, for Hopper (sm_90a), in plain
// fp32 on the CUDA cores (no TF32, no bf16), as register-tiled block products.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K11 _loop2_bwd_kernel (launched by _loop2_bwd) -> gnn_propagation_loop2_bwd
//
// The K reverse iterations of K10 (loop2.cu) on one W-node block, which is
// how a two-layer state net without dropout and BatchNorm trains. K10 saves
// only the states, so reverse step k, from the state traj[k-1] (s0 for k = 0)
// and the loop-invariant arc-label aggregation f, first aggregates again:
//   agg = adjT^T @ s,  x3 = [s | agg | f],  h0 = w0 @ x3 + b0,
//   y0  = act0(h0),  h1 = w1 @ y0 + b1                      recomputed
//   g   = g_traj[k] + gs              -> daff += (g * act1(h1), g)   (affine only)
//   dh1 = g * scale * act1'(h1)       -> db1, dw1 += dh1 (x) y0
//   dh0 = (w1^T @ dh1) * act0'(h0)    -> db0, dw0 += dh0 (x) x3
//   dx3 = w0^T @ dh0                  -> dfeats += dx3[2D:]  (summed over k)
//   gs  = dx3[:D] + adjT @ dx3[D:2D]
// (scale, shift) is the optional inference-BatchNorm affine after act1.
//
// Bound: the function needs 2*H1*(9D + 3AL + 1) flops a node and reverse step
// (the forward recomputed once, the reverse dense layers, the weight sums)
// and the block's arcs 4*D each (the aggregation and its reverse), against
// about 8*D + 4*AL bytes a node and step: the least time is the operations
// at the card's 67 TFLOP/s fp32 (chip_smoke.py::two_layer_train_bounds:
// 0.446 ms on the training batch's 1104 loop rows, K = 5, H1 = 150).
//
// Design: K13 (train_loop2_bwd.cu) without dropout, on the same reverse step
// (tile2.cuh::reverse_pass1, reverse_pass2: h0 on 4-node x 4-unit register
// tiles, kept in shared memory, h1 and dy0 as block products, the weight sums
// as block products over the block's nodes, dx3 on 4-node x C/8-column
// tiles), one CTA of 256 threads a block. What K11 adds around it:
// - the aggregation again every step, agg = adjT^T @ s_in, through compact
//   column lists (K10's: [16][W] weights and uint8 sources, built once a
//   launch); the gs contraction reads the compact row lists (K13's), so a CTA
//   holds both sets; a line with more than 16 nonzeros is read from device
//   memory, every entry, so a dense block is exact;
// - with the affine, daff's two sums over the block's nodes in a fixed order
//   (one thread a column), and g * scale before act1';
// - the feature rows stay in X's last AL rows for the whole launch, and
//   dfeats is summed over the steps by the owner thread of each entry;
// - the weight partials, daff and dfeats are summed in shared memory and
//   written once a launch; the next step's state and cotangent rows (2*D*W
//   floats) are prefetched with cp.async while a step computes; pass 1
//   double-buffers its y0 tiles (one barrier a chunk fewer).
// No atomics: each partial entry has one owner thread (or two fixed halves,
// tile2.cuh), so a second launch is bit-identical; torch sums the per-block
// partials in a fixed order. At the recipe (W = 128, D = 14, AL = 3,
// H1 = 150) a CTA takes 228,872 bytes: one CTA, 8 warps, an SM; forming h0
// again in pass 2 instead, two CTAs an SM in 128 registers (which spill), ran
// 13% slower on an NVIDIA H100 (PERF.md §6). Shapes whose layout does not
// fit take a leaner plan (tile2.cuh kLoop2BwdPlans): h0 recomputed in pass 2
// with the partials summed in device memory, two CTAs an SM where they fit;
// last, no lists, 2 units a thread and w1 read from device memory, which fits
// every shape the per-node kernel that this replaces took.
// The wide plan (tile2.cuh kTile2Wide, index 3, chosen only where no plan of
// kLoop2BwdPlans fits) takes every D, AL and H1: x3, G, h1 and dx3 lie in a
// workspace slice a block (gnn_propagation_loop2_bwd_workspace floats,
// allocated by the wrapper), the weights, biases and scale are read from
// device memory, the partials are summed in device memory, and h1, dx3 and
// the aggregation go through the 64-wide register tiles a chunk at a time:
// the same chains, so a forced wide plan gives the staged plans' bits. Its
// one instantiation is compiled from eval_loop2_bwd_wide.cu (this file under
// GNN_WIDE_TU), and the staged plans' at register width 64 from
// eval_loop2_bwd_64.cu (under GNN_MAXF64_TU), beside this file's.

#include "tile2.cuh"

namespace {

using namespace gnn;

int g_force = -1;  // gnn_propagation_loop2_bwd_force_plan

template <int MAXF, int UT, int MINB, bool WIDE>
__global__ void __launch_bounds__(kTileThreads, MINB)
loop2_bwd_tile_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                      const float* __restrict__ traj, const float* __restrict__ feats,
                      const float* __restrict__ w0, const float* __restrict__ b0,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ aff, const float* __restrict__ g_traj,
                      float* __restrict__ gs_out, float* __restrict__ dw0_out,
                      float* __restrict__ db0_out, float* __restrict__ dw1_out,
                      float* __restrict__ db1_out, float* __restrict__ dfeats,
                      float* __restrict__ daff_out, int B, int W, int D, int AL, int H1, int K,
                      int act0, int act1, Tile2Plan p, float* ws) {
  constexpr int DG = MAXF / 8, CT = 3 * MAXF / 8;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kReverse2Agg, W, D, AL, H1, p, WIDE);
  const int C = 2 * D + AL, S = L.S;
  float* WB = WIDE ? ws + (size_t)blockIdx.x * L.ws : base;  // x3, G, h1, dx3
  float* X = WB + L.x3;   // x3 (f in rows [2D, C) all launch), then the dagg rows [0, D)
  float* G = WB + L.dh1;  // g + gs, then dh1, then the new gs
  float* Y = base + L.yt;
  float* H = base + L.ht;
  float* w0T = WIDE ? nullptr : base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = WIDE ? nullptr : base + L.b0;
  float* PF = base + L.pf;
  float* DW = base + L.dw;  // [H1][C + 1] dw0 | db0, [D][H1] dw1, [D] db1, [2][D] daff, [AL][W] dfeats
  const float* b1s = WIDE ? b1 : base + L.b1;
  const float* scale = WIDE ? aff : base + L.aff;
  // list set 0: the columns (agg), set 1: the rows (gs)
  float* lw0 = base + L.lw;
  float* lw1 = lw0 + p.E * W;
  uint8_t* cnt0 = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* cnt1 = cnt0 + W;
  uint8_t* idx0 = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  uint8_t* idx1 = idx0 + p.E * W;
  const int b = blockIdx.x, t = threadIdx.x;
  const int ng = t >> 3, jg = t & 7;  // node block; unit group / column group
  const bool node_ok = 4 * ng < W;
  const bool affine = aff != nullptr;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  const W1Src w1src{w1s, w1, S, H1, p.w1g != 0};
  float* DW1 = DW + H1 * (C + 1);
  float* DB1 = DW1 + D * H1;
  float* DAFF = DB1 + D;
  float* DF = DAFF + 2 * D;
  const int ndw = H1 * (C + 1) + D * H1 + D + 2 * D + AL * W;

  // step k's rows: s_in [W][D], g [W][D]
  auto rows = [&](int k, int which) -> const float* {
    if (which == 0) return k > 0 ? traj + ((size_t)(k - 1) * B + b) * W * D : s0 + row0 * D;
    return g_traj + ((size_t)k * B + b) * W * D;
  };
  auto prefetch = [&](int k) {
    cp_rows(PF, rows(k, 0), W * D);
    cp_rows(PF + W * D, rows(k, 1), W * D);
  };
  // add v to a partial in device memory (the first reverse step writes it)
  auto sum_dev = [](float* dst, float v, bool first) { *dst = first ? v : *dst + v; };

  if constexpr (WIDE) {
    stage_rowsT<true>(feats + row0 * AL, W, AL, X, 2 * D);
  } else {
    stage_tile_weights(w0, C, b0, 1, w1, b1, C, D, H1, S, w0T, w1s, b0s, base + L.b1);
    if (affine)
      for (int d = t; d < D; d += kTileThreads) cp_async4(base + L.aff + d, aff + d);
    stage_rowsT(feats + row0 * AL, W, AL, X, 2 * D);
  }
  if (p.E > 0) {
    if (t < W)
      build_list(adj, W, t, p.E, true, lw0, idx0, cnt0);
    else if (t >= kMaxW && t - kMaxW < W)
      build_list(adj, W, t - kMaxW, p.E, false, lw1, idx1, cnt1);
  }
  if (p.dw)
    for (int i = t; i < ndw; i += kTileThreads) DW[i] = 0.0f;
  for (int i = t; i < D * W; i += kTileThreads) G[i] = 0.0f;
  if (p.pf) prefetch(K - 1);
  cp_async_wait_all();
  __syncthreads();

  const Tile2Rev rev{X, G, Y, H, w0T, b0s, b1s, w1src, W, C, D, H1, S, p.keep, p.nbuf,
                     W0Dev{w0, b0, C, 1, H1, 0}, WB + L.hw, WB + L.dx};
  for (int k = K - 1; k >= 0; --k) {
    const bool first = k == K - 1;
    // s_in into X rows [0, D), transposed; G = g_traj[k] + gs
    {
      const float* rs = p.pf ? PF : rows(k, 0);
      const float* rg = p.pf ? PF + W * D : rows(k, 1);
      for (int i = t; i < W * D; i += kTileThreads) {
        const int d = i / W, n = i % W, r = n * D + d;
        X[i] = rs[r];
        G[i] += rg[r];
      }
    }
    __syncthreads();  // s_in and G are full; the prefetch buffer is free
    if (p.pf && k > 0) prefetch(k - 1);
    // agg = adjT^T @ s_in into X rows [D, 2D) (thread: a node, every other
    // column; wide: MAXF columns at a time), the sources in K10's order, each
    // list entry read once for all of the thread's columns; with the affine,
    // daff's sum of g
    for (int dc = 0; dc < (WIDE ? D : 1); dc += MAXF) {
      const int n = t & (kMaxW - 1), d0 = dc + (t >> 7);
      float acc[MAXF / 2];
#pragma unroll
      for (int i = 0; i < MAXF / 2; ++i) acc[i] = 0.0f;
      auto add = [&](float a, int m) {
#pragma unroll
        for (int i = 0; i < MAXF / 2; ++i)
          if (d0 + 2 * i < D) acc[i] = fmaf(a, X[(d0 + 2 * i) * W + m], acc[i]);
      };
      if (n < W) {
        const int c = p.E > 0 ? cnt0[n] : W + 1;
        if (c <= p.E)
          for (int e = 0; e < c; ++e) add(lw0[e * W + n], idx0[e * W + n]);
        else
          for (int m = 0; m < W; ++m) add(adj[(size_t)m * W + n], m);
#pragma unroll
        for (int i = 0; i < MAXF / 2; ++i)
          if (d0 + 2 * i < D) X[(D + d0 + 2 * i) * W + n] = acc[i];
      }
    }
    for (int d = t; affine && d < D; d += kTileThreads) {
      float acc = 0.0f;
      for (int n = 0; n < W; ++n) acc += G[d * W + n];
      if (p.dw)
        DAFF[D + d] += acc;
      else
        sum_dev(daff_out + ((size_t)b * 2 + 1) * D + d, acc, first);
    }
    __syncthreads();  // X holds x3

    float h1[4][DG];
    reverse_pass1<UT, DG, WIDE>(rev, act0, ng, jg, h1);
    // outputs d0 + jg + 8 i (wide: a chunk at a time from h1's HW, the chunk's
    // dh1 parked there while the affine's sum reads G)
    auto affine_grad = [&](int d0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int d = d0 + jg + 8 * i;
          if (d < D) {
            float* gp = G + d * W + 4 * ng + n;
            const float g = *gp;
            float y, gr;
            act_and_grad(act1, h1[n][i], y, gr);
            *gp = g * y;
            h1[n][i] = g * scale[d] * gr;
          }
        }
    };
    auto put_dh1 = [&](int d0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int d = d0 + jg + 8 * i;
          if (d < D) G[d * W + 4 * ng + n] = h1[n][i];
        }
    };
    auto form_dh1 = [&](int d0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int d = d0 + jg + 8 * i;
          if (d < D) G[d * W + 4 * ng + n] *= act_grad(act1, h1[n][i]);
        }
    };
    if (affine) {
      // G = g * act1(h1) for daff's other sum; dh1 = (g * scale) * act1'(h1)
      // kept in h1 until the sum has read G
      if constexpr (WIDE) {
        for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
          tile_io<false>(h1, rev.HW, W, ng, d0 + jg, D);
          affine_grad(d0);
          tile_io<true>(h1, rev.HW, W, ng, d0 + jg, D);
        }
      } else if (node_ok) {
        affine_grad(0);
      }
      __syncthreads();  // G holds every node's g * act1(h1)
      for (int d = t; d < D; d += kTileThreads) {
        float acc = 0.0f;
        for (int n = 0; n < W; ++n) acc += G[d * W + n];
        if (p.dw)
          DAFF[d] += acc;
        else
          sum_dev(daff_out + (size_t)b * 2 * D + d, acc, first);
      }
      __syncthreads();  // the sum has read G
      if constexpr (WIDE) {
        for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
          tile_io<false>(h1, rev.HW, W, ng, d0 + jg, D);
          put_dh1(d0);
        }
      } else if (node_ok) {
        put_dh1(0);
      }
    } else if constexpr (WIDE) {
      for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
        tile_io<false>(h1, rev.HW, W, ng, d0 + jg, D);
        form_dh1(d0);
      }
    } else if (node_ok) {
      form_dh1(0);
    }
    __syncthreads();  // G holds every node's dh1

    const Tile2Parts parts =
        Tile2Parts{p.dw ? DW : nullptr, dw0_out + (size_t)b * H1 * C, db0_out + (size_t)b * H1,
                   dw1_out + (size_t)b * D * H1, db1_out + (size_t)b * D, C, 1, !first};
    float dx[4][CT];
    reverse_pass2<UT, CT, WIDE>(rev, parts, act0, ng, jg, dx);

    // dfeats += dx3[2D:]; dagg = dx3[D:2D] into X rows [0, D) (every reader
    // of x3 is past the last chunk's barrier); dx3[:D] kept; columns c0 + jg
    // + 8 i (wide: a chunk at a time from DX)
    auto route = [&](int c0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int node = 4 * ng + n;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = c0 + jg + 8 * i;
          if (c >= D && c < 2 * D)
            X[(c - D) * W + node] = dx[n][i];
          else if (c >= 2 * D && c < C && p.dw)
            DF[(c - 2 * D) * W + node] += dx[n][i];
          else if (c >= 2 * D && c < C)
            sum_dev(dfeats + (row0 + node) * AL + c - 2 * D, dx[n][i], first);
        }
      }
    };
    // gs[t] = dx3[:D] + sum_dst adjT[t][dst] * dagg[dst], into G
    auto contract = [&](int c0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int node = 4 * ng + n;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = c0 + jg + 8 * i;
          if (c < D)
            G[c * W + node] =
                dx[n][i] + line_dot(adj, W, node, false, p.E, lw1, idx1, cnt1, X + c * W);
        }
      }
    };
    if constexpr (WIDE) {
      for (int c0 = 0; node_ok && c0 < C; c0 += kWideCols) {
        tile_io<false>(dx, rev.DX, W, ng, c0 + jg, C);
        route(c0);
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
    __syncthreads();  // G holds gs; X rows [0, 2D) are rewritten by the next step
  }

  for (int i = t; i < W * D; i += kTileThreads) gs_out[row0 * D + i] = G[(i % D) * W + i / D];
  if (p.dw) {
    for (int i = t; i < H1 * C; i += kTileThreads)
      dw0_out[(size_t)b * H1 * C + i] = DW[(i / C) * (C + 1) + i % C];
    for (int j = t; j < H1; j += kTileThreads) db0_out[(size_t)b * H1 + j] = DW[j * (C + 1) + C];
    for (int i = t; i < D * H1; i += kTileThreads) dw1_out[(size_t)b * D * H1 + i] = DW1[i];
    for (int d = t; d < D; d += kTileThreads) db1_out[(size_t)b * D + d] = DB1[d];
    for (int i = t; affine && i < 2 * D; i += kTileThreads) daff_out[(size_t)b * 2 * D + i] = DAFF[i];
    for (int i = t; i < W * AL; i += kTileThreads)
      dfeats[row0 * AL + i] = DF[(i % AL) * W + i / AL];
  }
}

using Loop2BwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                            const float*, const float*, const float*, const float*, const float*,
                            float*, float*, float*, float*, float*, float*, float*, int, int, int,
                            int, int, int, int, int, Tile2Plan, float*);

// h0 kept: one CTA an SM; h0 recomputed with 4 units a thread: two where
// they fit, in at most 128 registers a thread (on an NVIDIA H100 at the
// recipe, 3.94 ms a launch against 4.79 with one CTA an SM); the leanest
// plan: one.
template <int MAXF>
Loop2BwdFn pick_variant(const Tile2Plan& p) {
  if (p.ut == 2) return loop2_bwd_tile_kernel<MAXF, 2, 1, false>;
  return p.keep ? loop2_bwd_tile_kernel<MAXF, 4, 1, false>
                : loop2_bwd_tile_kernel<MAXF, 4, 2, false>;
}

}  // namespace

#if defined(GNN_WIDE_TU)

namespace gnn {
// K11's wide-plan instantiation (eval_loop2_bwd_wide.cu).
Loop2BwdFn loop2_bwd_wide() { return loop2_bwd_tile_kernel<64, 4, 1, true>; }
}  // namespace gnn

#elif defined(GNN_MAXF64_TU)

namespace gnn {
// K11's staged instantiations at register width 64 (eval_loop2_bwd_64.cu).
Loop2BwdFn loop2_bwd_variant64(const Tile2Plan& p) { return pick_variant<64>(p); }
}  // namespace gnn

#else

namespace gnn {
Loop2BwdFn loop2_bwd_wide();
Loop2BwdFn loop2_bwd_variant64(const Tile2Plan& p);
}  // namespace gnn

namespace {

// The kernel and plan for a shape: the first plan of kLoop2BwdPlans that
// fits, else the wide plan (index 3), or plan g_force (>= 0) if it fits;
// nullptr if none. *ws: the plan's workspace floats a block.
Loop2BwdFn pick(int W, int D, int AL, int H1, Tile2Plan* p, size_t* bytes, int* index, int* ws) {
  if (!pick_plan(kReverse2Agg, kLoop2BwdPlans, W, D, AL, H1, p, bytes, index, g_force, ws))
    return nullptr;
  if (*ws > 0) return loop2_bwd_wide();
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return pick_variant<16>(*p);
    case 32:
      return pick_variant<32>(*p);
    default:
      return loop2_bwd_variant64(*p);
  }
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], traj [K, B, W, D] (K10's), feats [B, W, AL],
// w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D], aff [2, D] (null: none),
// g_traj [K, B, W, D] -> gs [B, W, D], the per-block partials dw0
// [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1], db1 [B, D] and daff [B, 2, D]
// (with aff), and dfeats [B, W, AL]; ws: the wide plan's workspace, B slices
// of gnn_propagation_loop2_bwd_workspace floats (null for a staged plan).
// Returns a cudaError_t code.
int gnn_propagation_loop2_bwd(const float* adjT, const float* s0, const float* traj,
                              const float* feats, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* aff,
                              const float* g_traj, float* gs, float* dw0, float* db0, float* dw1,
                              float* db1, float* dfeats, float* daff, int B, int W, int D, int AL,
                              int H1, int K, int act0, int act1, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if ((aff == nullptr) != (daff == nullptr)) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Loop2BwdFn fn = pick(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, feats, w0, b0, w1, b1, aff, g_traj, gs, dw0, db0, dw1, db1, dfeats, daff, B,
      W, D, AL, H1, K, act0, act1, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block the plan gnn_propagation_loop2_bwd picks for
// this shape needs (0 for a staged plan), or -1 if none fits.
int gnn_propagation_loop2_bwd_workspace(int W, int D, int AL, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick(W, D, AL, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_loop2_bwd
// launches for this shape. Returns a cudaError_t code.
int gnn_propagation_loop2_bwd_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Loop2BwdFn fn = pick(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kLoop2BwdPlans (3: the wide plan) from now on,
// where it fits (a launch at a shape it does not fit fails), or the first
// plan that fits again (index -1): for timing one plan against another.
void gnn_propagation_loop2_bwd_force_plan(int index) { g_force = index; }

}  // extern "C"

#endif  // GNN_WIDE_TU, GNN_MAXF64_TU
