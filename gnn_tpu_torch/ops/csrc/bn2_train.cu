// The reverse of the BatchNorm-training iteration of a two-layer state net
// for Hopper (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16):
// the reference's default state net (trailing BatchNorm, input dropout) with
// a hidden layer of width H1.
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K15 _bn2_bwd_kernel (launched by _bn2_bwd_call) -> gnn_bn2_backward
// Its forward, K14, is in bn2_fwd.cu.
//
// As K1/K2 (bn_train.cu), one launch runs one iteration over every block row,
// since the BatchNorm couples every block through the batch moments, and
// [D]-sized glue (ops/bn.py) runs between launches. C = 2D + F is the width
// of the dense input x3 = [s | agg | feats]; w0_aug = [Ws | Wa | Wf | b0]
// [H1, C + 1], w1 [D, H1], b1 [D]. K15, the reverse of K14 with the
// BatchNorm backward folded in from the [9, D] coefficient rows bnv
// (ops/bn.py::BNV_ROWS), h0 and h1 recomputed:
//   gy    = gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2)
//   dh1   = gy * act1'(h1)                     -> db1, dw1 (per-block partials)
//   dh0   = (w1^T @ dh1) * act0'(h0)           -> dw0 = dh0^T @ [drop(x3); 1]
//   dagg  = (dh0 @ Wa) * dmask,  ds = (dh0 @ Ws) * dmask + adjT @ dagg
//   red   = (sum ds, sum ds * x_hat_prev)      (per-block partial)
//
// Row r < Bl reads adj_loop[r], the rest adj_dep[r - Bl], where they lie.
// K15 is one reverse step of tile2.cuh (reverse_pass1, reverse_pass2, the
// device code of K13 and K11), one CTA of 256 threads a block row: x3 and gy
// are formed transposed in shared memory; pass 1 forms h0 on 4-node x 4-unit
// register tiles and h1 as a block product; dh1 = gy * act1'(h1) on the owner
// threads of h1; pass 2 forms dh0, the bias-augmented weight sums as block
// products over the block's nodes (dw0 [H1][C + 1] with db0 its last column,
// dw1, db1, each entry written once by its owner thread, or two fixed halves)
// and dx3 on 4-node x C/8-column tiles; ds contracts dagg through compact row
// lists ([16][W] weights and uint8 destinations, built once a launch; a row
// with more than 16 arcs is read from device memory, every entry, so a dense
// block is exact). Keep bits, bnv and the node mask are read from device
// memory where they are used. No atomics: a result does not vary between
// runs. h0 is formed again in pass 2 rather than kept (+2*H1*C flops a node):
// at the recipe a CTA takes 94,936 bytes, so two CTAs of 256 threads, 16
// warps, in at most 128 registers a thread, fit an SM and one hides the
// other's staging (a launch is a single reverse step); keeping h0 (158,424
// bytes, one CTA an SM) ran 34% slower. The last plan of tile2.cuh's
// kBn2BwdPlans (no lists, 2 units a thread, w1 read from device memory) fits
// every shape the per-node kernel that this replaces took.
//
// Bound: the hidden layer sets it: 2*H1*(9D + 2F + 1) flops a node (the
// forward again, the bias-augmented weight sums, dx3's state and aggregation
// columns: no feats cotangent), against about 7*D + F floats a node read and
// written and the adjacency read once: the least time is set
// by the operations at the card's fp32 rate (chip_smoke.py
// ::two_layer_train_bounds: K15 0.097 ms on the training batch's 1214 block
// rows, H1 = 150).
//
// The wide plan (tile2.cuh kTile2Wide, index 2, chosen only where neither
// plan of kBn2BwdPlans fits) takes every D, F and H1: x3, G, h1 and dx3 lie
// in a workspace slice a block row (gnn_bn2_backward_workspace floats,
// allocated by the wrapper), the weights and biases are read from device
// memory, and h1 and dx3 go through the 64-wide register tiles a chunk at a
// time: the same chains, so a forced wide plan gives the staged plans' bits.
// Its one instantiation is compiled from bn2_train_wide.cu (this file under
// GNN_WIDE_TU), beside this file's.

#include "tile2.cuh"

namespace {

using namespace gnn;

int g_force = -1;  // gnn_bn2_backward_force_plan

// K15: one reverse two-layer BN-training iteration over every block row.
template <int MAXF, int UT, int MINB, bool WIDE>
__global__ void __launch_bounds__(kTileThreads, MINB)
bn2_bwd_tile_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
                    const float* __restrict__ y_prev, const float* __restrict__ y_k,
                    const float* __restrict__ agg, const uint8_t* __restrict__ keep,
                    const float* __restrict__ feats, const float* __restrict__ w0_aug,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ ds_in, const float* __restrict__ gsel,
                    const float* __restrict__ bnv, const float* __restrict__ flag,
                    const float* __restrict__ nm, float* __restrict__ ds, float* __restrict__ dw0,
                    float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dagg,
                    float* __restrict__ red, int Bl, int W, int D, int F, int H1, int act0,
                    int act1, int mode, float da, float db, Tile2Plan p, float* ws) {
  constexpr int DG = MAXF / 8, CT = 3 * MAXF / 8;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kReverse2, W, D, F, H1, p, WIDE);
  const int C = 2 * D + F, S = L.S;
  float* WB = WIDE ? ws + (size_t)blockIdx.x * L.ws : base;  // x3, G, h1, dx3
  float* X = WB + L.x3;   // x3; then dagg in rows [0, D), ds * x_hat_prev in [D, 2D)
  float* G = WB + L.dh1;  // gy, then dh1, then ds
  float* w0T = WIDE ? nullptr : base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = WIDE ? nullptr : base + L.b0;
  float* lw = base + L.lw;
  const float* b1s = WIDE ? b1 : base + L.b1;
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  const int r = blockIdx.x, t = threadIdx.x;
  const int ng = t >> 3, jg = t & 7;  // node block; unit group / column group
  const bool node_ok = 4 * ng < W;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  const uint8_t* kp = mode != kNoDrop ? keep + row0 * C : nullptr;  // [W][C] x3 order

  if constexpr (!WIDE)
    stage_tile_weights(w0_aug, C + 1, w0_aug + C, C + 1, w1, b1, C, D, H1, S, w0T, w1s, b0s,
                       base + L.b1);
  if (p.E > 0 && t < W) build_list(adj, W, t, p.E, false, lw, idx, cnt);
  // the forward's dropped x3, transposed: s_prev (rounded as the plain
  // version: multiply, then add), agg, feats; consecutive threads take
  // consecutive nodes
  for (int i = t; i < C * W; i += kTileThreads) {
    const int c = i / W, n = i % W;
    const size_t nr = row0 + n;
    float v;
    if (c < D)
      v = __fadd_rn(__fmul_rn(y_prev[nr * D + c], bnv[c]), bnv[D + c]);
    else if (c < 2 * D)
      v = agg[nr * D + c - D];
    else
      v = feats[nr * F + c - 2 * D];
    X[i] = drop(mode, da, db, v, kp != nullptr && kp[n * C + c] != 0);
  }
  // gy from the state cotangent and the BatchNorm backward coefficients
  const float f = *flag;
  for (int i = t; i < D * W; i += kTileThreads) {
    const int d = i / W, n = i % W;
    const size_t e = (row0 + n) * D + d;
    const float g = ds_in[e] + f * gsel[e];
    const float xk = (y_k[e] - bnv[2 * D + d]) * bnv[3 * D + d];
    G[i] = bnv[4 * D + d] * g - nm[row0 + n] * (bnv[5 * D + d] + xk * bnv[6 * D + d]);
  }
  cp_async_wait_all();
  __syncthreads();

  const Tile2Rev rev{X, G, base + L.yt, base + L.ht, w0T, b0s, b1s,
                     W1Src{w1s, w1, S, H1, p.w1g != 0}, W, C, D, H1, S, p.keep, p.nbuf,
                     W0Dev{w0_aug, w0_aug + C, C + 1, C + 1, H1, 0}, WB + L.hw, WB + L.dx};
  float h1[4][DG];
  reverse_pass1<UT, DG, WIDE>(rev, act0, ng, jg, h1);
  // dh1 = gy * act1'(h1) into G (each entry read and written by its owner),
  // outputs d0 + jg + 8 i (wide: a chunk at a time from h1's HW)
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

  float* dw0_r = dw0 + (size_t)r * H1 * (C + 1);  // bias-augmented: db0 is its last column
  const Tile2Parts parts{nullptr, dw0_r, dw0_r + C, dw1 + (size_t)r * D * H1,
                         db1 + (size_t)r * D, C + 1, C + 1, false};
  float dx[4][CT];
  reverse_pass2<UT, CT, WIDE>(rev, parts, act0, ng, jg, dx);

  // dx = dh0 @ [Ws | Wa] through the dropout's derivative a * keep; dagg out
  // and into X rows [0, D) (every reader of x3 is past the last chunk's
  // barrier); columns c0 + jg + 8 i (wide: a chunk at a time from DX, the
  // state columns parked again)
  auto route = [&](int c0) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int node = 4 * ng + n;
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        const int c = c0 + jg + 8 * i;
        if (c < 2 * D) {
          const float v = dx[n][i] * drop_grad(mode, da, kp != nullptr && kp[node * C + c] != 0);
          if (c < D) {
            dx[n][i] = v;
          } else {
            X[(c - D) * W + node] = v;
            dagg[(row0 + node) * D + c - D] = v;
          }
        }
      }
    }
  };
  // ds[t] = dxs[t] + sum_dst adjT[t][dst] * dagg[dst] into G, ds * x_hat_prev
  // into X rows [D, 2D)
  auto contract = [&](int c0) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int node = 4 * ng + n;
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        const int c = c0 + jg + 8 * i;
        if (c < D) {
          const float v = dx[n][i] + line_dot(adj, W, node, false, p.E, lw, idx, cnt, X + c * W);
          G[c * W + node] = v;
          X[(D + c) * W + node] =
              v * ((y_prev[(row0 + node) * D + c] - bnv[7 * D + c]) * bnv[8 * D + c]);
        }
      }
    }
  };
  if constexpr (WIDE) {
    for (int c0 = 0; node_ok && c0 < 2 * D; c0 += kWideCols) {
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
  __syncthreads();
  for (int i = t; i < W * D; i += kTileThreads) ds[row0 * D + i] = G[(i % D) * W + i / D];
  // the next reverse step's reduction partials (sum ds, sum ds * x_hat_prev)
  for (int q = t; q < 2 * D; q += kTileThreads) {
    const float* row = q < D ? G + q * W : X + q * W;
    float acc = 0.0f;
    for (int n = 0; n < W; ++n) acc += row[n];
    red[(size_t)r * 2 * D + q] = acc;
  }
}

using Bn2BwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const uint8_t*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, const float*, const float*,
                          float*, float*, float*, float*, float*, float*, int, int, int, int, int,
                          int, int, int, float, float, Tile2Plan, float*);

}  // namespace

#ifdef GNN_WIDE_TU

namespace gnn {
// K15's wide-plan instantiation (bn2_train_wide.cu).
Bn2BwdFn bn2_bwd_wide() { return bn2_bwd_tile_kernel<64, 4, 1, true>; }
}  // namespace gnn

#else

namespace gnn {
Bn2BwdFn bn2_bwd_wide();
}  // namespace gnn

namespace {

bool shape_ok(int R, int Bl, int W, int D, int F, int H1) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && H1 > 0;
}

// 4 units a thread: two CTAs an SM, in at most 128 registers a thread; the
// leanest plan: one.
template <int MAXF>
Bn2BwdFn pick_variant(const Tile2Plan& p) {
  return p.ut == 2 ? bn2_bwd_tile_kernel<MAXF, 2, 1, false> : bn2_bwd_tile_kernel<MAXF, 4, 2, false>;
}

// K15's kernel and plan for a shape: the first plan of kBn2BwdPlans that
// fits, else the wide plan (index 2), or plan g_force (>= 0) if it fits;
// nullptr if none. *ws: the plan's workspace floats a block row.
Bn2BwdFn pick_bwd(int W, int D, int F, int H1, Tile2Plan* p, size_t* bytes, int* index,
                  int* ws) {
  if (!pick_plan(kReverse2, kBn2BwdPlans, W, D, F, H1, p, bytes, index, g_force, ws))
    return nullptr;
  if (*ws > 0) return bn2_bwd_wide();
  switch (width_class(D > F ? D : F)) {
    case 16:
      return pick_variant<16>(*p);
    case 32:
      return pick_variant<32>(*p);
    default:
      return pick_variant<64>(*p);
  }
}

}  // namespace

extern "C" {

// As gnn_bn2_forward, plus y_prev, y_k, agg, ds_in, gsel [R, W, D]; bnv [9, D];
// flag a device float (0 or 1) -> ds, dagg [R, W, D] and the per-block
// partials dw0 [R, H1, 2D + F + 1], dw1 [R, D, H1], db1 [R, D], red [R, 2, D];
// ws: the wide plan's workspace, R slices of gnn_bn2_backward_workspace floats
// (null for a staged plan). Returns a cudaError_t code.
int gnn_bn2_backward(const float* adj_loop, const float* adj_dep, const float* y_prev,
                     const float* y_k, const float* agg, const uint8_t* keep, const float* feats,
                     const float* w0_aug, const float* w1, const float* b1, const float* ds_in,
                     const float* gsel, const float* bnv, const float* flag, const float* nm,
                     float* ds, float* dw0, float* dw1, float* db1, float* dagg, float* red, int R,
                     int Bl, int W, int D, int F, int H1, int act0, int act1, int mode, float da,
                     float db, void* stream, float* ws) {
  if (!shape_ok(R, Bl, W, D, F, H1)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Bn2BwdFn fn = pick_bwd(W, D, F, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1, ds_in, gsel, bnv, flag,
      nm, ds, dw0, dw1, db1, dagg, red, Bl, W, D, F, H1, act0, act1, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block row the plan gnn_bn2_backward picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_bn2_backward_workspace(int W, int D, int F, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick_bwd(W, D, F, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bn2_backward launches for
// this shape. Returns a cudaError_t code.
int gnn_bn2_backward_info(int W, int D, int F, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Bn2BwdFn fn = pick_bwd(W, D, F, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kBn2BwdPlans (2: the wide plan) from now on, where
// it fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_bn2_backward_force_plan(int index) { g_force = index; }

}  // extern "C"

#endif  // GNN_WIDE_TU
