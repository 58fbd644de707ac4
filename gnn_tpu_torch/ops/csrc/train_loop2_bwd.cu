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
// passes over 32-unit chunks of the hidden layer a reverse step:
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

#include "tile2.cuh"

namespace {

using namespace gnn;

template <int MAXF, int UT>
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
                       Tile2Plan p) {
  constexpr int DG = MAXF / 8, CT = 3 * MAXF / 8, CH = 8 * UT;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(true, W, D, AL, H1, p);
  const int C = 2 * D + AL, S = L.S;
  float* X = base + L.x3;   // x3, then the dagg rows [0, D)
  float* G = base + L.dh1;  // g + gs, then dh1, then the new gs
  float* Y = base + L.yt;   // y0 of a chunk
  float* H = base + L.ht;   // h0, then dh0 (rows j, or j - j0 without keep)
  float* w0T = base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = base + L.b0;
  float* PF = base + L.pf;
  float* lw = base + L.lw;
  float* DW = base + L.dw;  // [H1][C + 1] dw0 | db0, [D][H1] dw1, [D] db1
  float* b1s = base + L.b1;
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

  stage_tile_weights(w0, b0, w1, b1, C, D, H1, S, w0T, w1s, b0s, b1s);
  if (p.E > 0 && t < W) build_list(adj, W, t, p.E, false, lw, idx, cnt);
  if (p.dw)
    for (int i = t; i < H1 * (C + 1) + D * H1 + D; i += kTileThreads) DW[i] = 0.0f;
  for (int i = t; i < D * W; i += kTileThreads) G[i] = 0.0f;
  if (p.pf) prefetch(K - 1);
  cp_async_wait_all();
  __syncthreads();

  const int nch = (S + CH - 1) / CH;
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
#pragma unroll
    for (int i = 0; i < DG; ++i) {
      const int d = jg + 8 * i;
#pragma unroll
      for (int n = 0; n < 4; ++n) h1[n][i] = d < D ? b1s[d] : 0.0f;
    }
    for (int ci = 0; ci < nch; ++ci) {
      const int j0 = ci * CH, jc = min(CH, S - j0);
      if (node_ok && UT * jg < jc) {
        float a[4][UT];
        first_product<UT>(X, W, C, w0T + j0 + UT * jg, S, b0s + j0 + UT * jg, ng, a);
        if (p.keep) store_tile<UT>(H, j0 + UT * jg, ng, W, a);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < UT; ++u) a[n][u] = activate(act0, a[n][u]);
        store_tile<UT>(Y, UT * jg, ng, W, a);
      }
      __syncthreads();  // the chunk's y0 tile is full
      if (node_ok) second_product<UT, DG>(Y, W, w1src, j0, jc, ng, jg, D, h1);
      __syncthreads();  // the tile is rewritten by the next chunk
    }
    // dh1 = (g + gs) * act1'(h1) into G (each entry read and written by its owner)
    if (node_ok)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int d = jg + 8 * i;
          if (d < D) G[d * W + 4 * ng + n] *= act_grad(act1, h1[n][i]);
        }
    __syncthreads();  // G holds every node's dh1
    if (t < D) {
      float acc = 0.0f;
      for (int n = 0; n < W; ++n) acc += G[t * W + n];
      float* dst = p.dw ? DB1 + t : db1_out + (size_t)b * D + t;
      *dst = p.dw || !first ? *dst + acc : acc;
    }

    // pass 2: dh0, the weight sums and dx3, a chunk at a time
    float dx[4][CT];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < CT; ++i) dx[n][i] = 0.0f;
    for (int ci = 0; ci < nch; ++ci) {
      const int j0 = ci * CH, jc = min(CH, S - j0), hr = p.keep ? j0 : 0;
      if (node_ok && UT * jg < jc) {
        const int j = j0 + UT * jg;
        float dy[4][UT], h[4][UT];
        dy_product<UT>(G, W, D, w1src, j, ng, dy);
        if (p.keep)
          load_tile<UT>(H, hr + UT * jg, ng, W, h);
        else
          first_product<UT>(X, W, C, w0T + j, S, b0s + j, ng, h);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < UT; ++u) {
            float y, g;
            act_and_grad(act0, h[n][u], y, g);
            dy[n][u] *= g;
            h[n][u] = y;
          }
        store_tile<UT>(Y, UT * jg, ng, W, h);         // y0
        store_tile<UT>(H, hr + UT * jg, ng, W, dy);   // dh0
      }
      __syncthreads();  // the chunk's y0 and dh0 tiles are full
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
          return p.dw ? DW1 + d * H1 + j : dw1_out + ((size_t)b * D + d) * H1 + j;
        }
        const int q = 4 * qq + i;
        if (p.dw) return DW + j * (C + 1) + q;
        return q < C ? dw0_out + ((size_t)b * H1 + j) * C + q : db0_out + (size_t)b * H1 + j;
      };
      auto ncols = [&](int qq) { return qq >= nq0 ? min(4, D - 4 * (qq - nq0)) : min(4, C + 1 - 4 * qq); };
      float acc[UT][4];
      int pending = -1;  // the quad whose second-half sum waits for the barrier
      if (r0 < jr)
        for (int qq = split ? ng >> 1 : ng; qq < nq; qq += split ? 16 : 32) {
          const bool w1part = qq >= nq0;
          const int q0 = 4 * (w1part ? qq - nq0 : qq), ncol = w1part ? D : C + 1;
          const float* uni = w1part ? Y : H;
          const int ur = (w1part ? 0 : hr) + r0;
          const float* cols[4];  // null: the column of ones, or past the last column
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = q0 + i;
            cols[i] = q >= ncol || (!w1part && q == C) ? nullptr : (w1part ? G : X) + q * W;
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
              *dst = p.dw || !first ? *dst + acc[u][i] : acc[u][i];
            }
          }
        }
      // dx3 += dh0 @ w0 over the chunk
      if (node_ok) dx_product<UT, CT>(H, hr, W, w0T + j0, S, jc, C, ng, jg, dx);
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

    // dfd[k] = dx3[2D:]; dagg = dx3[D:2D] * a*ma into X rows [0, D) (every
    // reader of x3 is past the last chunk's barrier); dx3[:D] * a*ms kept
    if (node_ok)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int node = 4 * ng + n;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = jg + 8 * i;
          if (c < D)
            dx[n][i] *= drop_grad(mode, da, ks != nullptr && ks[node * D + c] != 0);
          else if (c < 2 * D)
            X[(c - D) * W + node] =
                dx[n][i] * drop_grad(mode, da, ka != nullptr && ka[node * D + c - D] != 0);
          else if (c < C)
            dfd[(kb * W + node) * AL + c - 2 * D] = dx[n][i];
        }
      }
    __syncthreads();  // X holds every node's dagg
    // gs[t] = dx3[:D] * a*ms + sum_dst adjT[t][dst] * dagg[dst], into G
    if (node_ok)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int node = 4 * ng + n;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = jg + 8 * i;
          if (c < D)
            G[c * W + node] =
                dx[n][i] + line_dot(adj, W, node, false, p.E, lw, idx, cnt, X + c * W);
        }
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
                          Tile2Plan);

template <int MAXF>
Train2Fn pick_ut(int ut) {
  return ut == 4 ? train2_bwd_tile_kernel<MAXF, 4> : train2_bwd_tile_kernel<MAXF, 2>;
}

// The kernel and plan for a shape (nullptr if none fits).
Train2Fn pick(int W, int D, int AL, int H1, Tile2Plan* p, size_t* bytes, int* index) {
  if (!pick_plan(true, kTrain2Plans, W, D, AL, H1, p, bytes, index)) return nullptr;
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return pick_ut<16>(p->ut);
    case 32:
      return pick_ut<32>(p->ut);
    case 64:
      return pick_ut<64>(p->ut);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// As gnn_train_loop2, plus traj, agg, g_traj [K, B, W, D] -> gs [B, W, D] and
// the per-block partials dw0 [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1],
// db1 [B, D], and dfd [K, B, W, AL]. Returns a cudaError_t code.
int gnn_train_loop2_bwd(const float* adjT, const float* s0, const float* traj, const float* agg,
                        const uint8_t* ms, const uint8_t* ma, const float* fd, const float* w0,
                        const float* b0, const float* w1, const float* b1, const float* g_traj,
                        float* gs, float* dw0, float* db0, float* dw1, float* db1, float* dfd,
                        int B, int W, int D, int AL, int H1, int K, int act0, int act1, int mode,
                        float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (mode != kNoDrop && (ms == nullptr || ma == nullptr)) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index;
  const Train2Fn fn = pick(W, D, AL, H1, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, gs, dw0, db0, dw1, db1, dfd, B, W,
      D, AL, H1, K, act0, act1, mode, da, db, p);
  return cudaGetLastError();
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_train_loop2_bwd launches
// for this shape. Returns a cudaError_t code.
int gnn_train_loop2_bwd_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index;
  const Train2Fn fn = pick(W, D, AL, H1, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

}  // extern "C"
