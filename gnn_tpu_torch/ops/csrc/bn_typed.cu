// Typed BatchNorm-training propagation kernels of composite (per-node-type)
// GNNs for Hopper (sm_90a), in plain fp32 on the CUDA cores (no TF32, no
// bf16).
//
// Replaces gnn_tpu/ops/pallas_typed.py:
//   K16 _bnT_fwd_kernel (launched by _bnT_fwd_call) -> gnn_bnT_forward
//   K17 _bnT_bwd_kernel (launched by _bnT_bwd_call) -> gnn_bnT_backward
//
// They are K1/K2 (bn_fwd.cu, bn_train.cu) with a node type per node: node n
// of type t(n) normalizes with type t(n)'s affine, meets only rows [t*D,
// (t+1)*D) of the stacked weights w_stk [T*D, C] (C = 2D + F + 1, rows
// [Ws|Wa|Wf|b] of each type) and type t(n)'s activation, and the moment and
// reduction sums are split by type:
//   K16  s = y1 * scale1[t] + shift1[t], s_old = y2 * scale2[t] + shift2[t]
//        marg, agg = adjT^T @ s (+ rT), x3 = drop([s | agg | feats]) as K1
//        y = act_t(w_stk[t] @ [x3; 1]),  msum[t'] = sum over type-t' nodes of y * nm
//   K17  gy = bnv[t][4] * (ds_in + flag * gsel) - nm * (bnv[t][5] + x_hat_k * bnv[t][6])
//        dh = gy * act_t'(h),  dw[t rows] += dh^T @ [x3; 1]   (per-block partial)
//        dagg = (dh @ Wa[t]) * dmask,  ds = (dh @ Ws[t]) * dmask + adjT @ dagg
//        red[t'] = (sum ds, sum ds * x_hat_prev) over type-t' nodes
// Types are indices (int32, 0 on padded nodes), type t's activation code the
// byte acts[t] of a device array. gnn_tpu multiplies every node
// by all T weight slabs and selects with a one-hot mask; the rows of other
// types are multiplied by 0 there, so computing only the node's own rows is
// the same function, and the dense work stays K1's whatever T is. Padded
// nodes select type 0 for the state update, as the raw one-hot does; nm
// masks them out of margins, moments and the moment term of gy, and red
// counts them in type 0 (gnn_tpu's raw type mask; their ds is 0).
//
// Both kernels run one launch over every block row (row r < Bl reads
// adj_loop[r], the rest adj_dep[r - Bl]), one CTA of NT threads a row, on
// tile2.cuh's staging and adjacency lists; sums over nodes leave as per-block
// partials that the caller adds up in order (no float atomics: a repeat
// launch is bit-identical, and every plan gives the same bits). Each type's
// sums run over its nodes in counting-sorted order (order_nodes: ascending
// node order within a type), so they cost K1's and K2's node loops whatever
// T is. The stacked weights are staged transposed (wT [T][C][D4]) where they
// fit, else read through the L1/L2 caches (the same values into the same FMAs
// in the same order).
//
// K16's design is K1's (bn_fwd.cu) with per-type weights:
// - no resident adjacency: each column's nonzero entries go into a compact
//   list ([16][W] weights and uint8 sources, tile2.cuh::build_col_lists,
//   from coalesced 16-byte reads) in source order, so agg sums the dense
//   contraction's nonzero terms in its order at 2*D flops an arc; a column of
//   more than 16 entries is read from device memory, every entry, so a dense
//   block is exact;
// - every operand (wT, the per-type affines, nm, the node types, y1, y2 and
//   feats transposed into x3's rows, rT into the node-major row buffer, the
//   keep bytes) is staged with cp.async, issued together ahead of the list
//   build and waited on once;
// - s and s_old through the node's type's affines with the plain version's
//   rounding (__fmul_rn, then __fadd_rn), the movement test one thread a
//   node, d ascending;
// - h in the per-node order (bias first, then c ascending) from the node's
//   own type's rows of wT, NT / W threads a node each taking a block of
//   outputs, four a 16-byte read; the type's activation selected per node;
// - agg and y leave through the row buffer [W][D | 1] by coalesced writes;
//   msum adds each type's nodes in their counting-sorted order.
// So y, agg, marg and msum are bit for bit the per-node K16's that this
// replaced (one thread a node, a resident [W][W + 1] adjacency contracted
// densely). At the composite recipe (W 128, D 14, F 3, T 4) a CTA of plan 0
// takes 49,568 bytes. The plans (kBnTFwdPlans: threads, list room, keep bytes
// staged, weights staged) are mirrored by ops/typed.py::_bnT_fwd_plan; the
// last (128 threads, no lists, only the small rows staged) fits every shape
// the per-node K16 took.
//
// K17's design is K2's (bn_train.cu) with per-type weights:
// - no resident adjacency: each row's nonzero entries go into a compact list
//   at staging ([8][W] weights and uint8 destinations, built from coalesced
//   16-byte reads, tile2.cuh::build_row_lists), so ds = dxs + adjT @ dagg
//   costs 2*D an arc, not 2*D*W a node (a row of more than 8 entries is
//   read from device memory, every entry, so a dense block is exact);
// - the rows (y_prev, ds_in, gsel, y_k node-major by 16-byte copies; agg and
//   feats transposed into x3's rows), the stacked weights transposed
//   (wT [T][C][D4]), the per-type bnv rows, nm, the types and the keep bytes
//   are staged with cp.async, issued together and waited on once; weights
//   that do not fit are read through the L1/L2 caches;
// - h recomputed per node from its own type's rows in the per-node order
//   (bias first, then c ascending), NT / W threads a node taking every
//   (NT / W)-th output; dx = dh @ [Ws | Wa] from the transposed weights, four
//   outputs a 16-byte read;
// - dw [T * D][C] and red sum each type's nodes in their counting-sorted
//   order (ord, tst), one work item (type, 4 outputs x 4 columns) a thread:
//   the outputs are bit for bit the per-node K17's; mixed per-type
//   activations select their derivative per node (their speed is not the
//   target). Splitting each type's nodes into two halves summed on two
//   threads (the CTA's other half idles here, 36% of the kernel's cycles,
//   tools/phase_marks.py) ran 2% slower.
// The plans (kBnTBwdPlans: threads, list room, rows staged, weights staged)
// are mirrored by ops/typed.py::_bnT_bwd_plan; the last (128 threads, no
// staging, no lists) fits every shape the per-node K17 took.
//
// Bound: as K1/K2, a launch reads every block's adjacency once (64 KiB at
// W = 128), which dominates the bytes moved; the types add 4*W bytes a block
// and do not grow with T. The least time is set by bytes.
//
// The staged plans take D up to 64 and T up to 32. The wide plans (index 3
// of each list, chosen only where no staged plan fits, as K1's and K2's)
// take every D, F and T: x3, the row buffers, K17's dh, ds and dagg, and the
// types' starts lie in a workspace slice a block row
// (gnn_bnT_forward_workspace / gnn_bnT_backward_workspace floats, allocated
// by the wrapper); the stacked weights, the affines and bnv are read
// through the caches; a thread's outputs go through h [JT] (and K17's dx)
// in chunks of JT: the same chains, so a forced wide plan gives the staged
// plans' bits. Their instantiations are compiled from bn_typed_wide.cu (this
// file under GNN_WIDE_TU), and the staged plans' at register width 64 from
// bn_typed_64.cu (under GNN_MAXF64_TU), beside this file's.

#include "tile2.cuh"

namespace gnn {

// The plans are types of namespace gnn (not of this file's unnamed one), so
// the wide instantiations' getters link across bn_typed.cu and
// bn_typed_wide.cu.

// A K17 plan: threads a CTA, room of the row lists (0: the adjacency is read
// from device memory), whether the rows and keep bytes are staged, whether
// the stacked weights are staged (else read through the L1/L2 caches).
struct BnTBwdPlan {
  int nt, E, st, ws;
};

// A K16 plan: threads a CTA, room of the column lists (0: the adjacency is
// read from device memory), whether the keep bytes are staged, whether the
// stacked weights are staged (else read through the L1/L2 caches).
struct BnTFwdPlan {
  int nt, E, st, ws;
};

}  // namespace gnn

namespace {

using namespace gnn;

// the wide plans' index, after the three staged plans of each list
constexpr int kBnTWideIndex = 3;

// ---- K17

// The first is the composite recipe's (T = 4, D 14, F 3: 72,704 bytes, three
// CTAs of 256 threads an SM; lists of 8, where K2's hold 16, make room for
// the stacked weights); the second leaves weights too large for a CTA in
// device memory; the last fits every shape the per-node K17 took
// (ops/typed.py::_BNT_BWD_PLANS mirrors the list).
constexpr BnTBwdPlan kBnTBwdPlans[] = {{256, 8, 1, 1}, {256, 8, 1, 0}, {128, 0, 0, 0}};
// the wide plan: 256 threads, lists of 8, nothing staged
constexpr BnTBwdPlan kBnTBwdWide = {256, 8, 0, 0};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K17's shared memory (bytes for the list counts and
// destinations, after the floats), each region a multiple of 16 bytes: x3 X
// [C1][W] (dropped, transposed), dh [D][W], with ws the stacked weights
// transposed wT [T][C][D4] (D4 = D rounded up to 4, zero past D; row C1 of a
// type its bias), bnv [T][9][D], nm [W], the node types, the nodes ordered
// by type and the types' starts (ints [W], [W], [T + 1]); with st y_prev
// [W][D] and the keep bytes [W][C1]; a late region (with st: ds_in, gsel,
// y_k [W][D] each; then dagg [W][D|1]); the lists [E][W]. ds [W][D|1] takes
// X once it is read.
// The wide plan: in a block row's workspace slice of ws floats x3 [C1][W],
// dh [D][W], dagg [W][D|1], ds [W][D|1] and the types' starts [T + 1]
// (ints); in shared memory nm [W], the types and their order ([W], [W]
// ints), the lists, then the bytes.
struct BnTBwdLayout {
  int x, dh, w, v, nm, ty, ord, tst, yp, kp, di, gs, yk, da, lw, ds, ws;
  size_t cnt_b, idx_b, bytes;
};

__host__ __device__ inline BnTBwdLayout bwdT_layout(int W, int D, int F, int T,
                                                    const BnTBwdPlan& p, bool wide = false) {
  BnTBwdLayout L{};
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1;
  int o = 0;
  if (wide) {
    L.w = L.v = L.yp = L.kp = L.di = L.gs = L.yk = -1;
    L.x = o;
    o += round4(C1 * W);
    L.dh = o;
    o += round4(D * W);
    L.da = o;
    o += round4(W * DP);
    L.ds = o;
    o += round4(W * DP);
    L.tst = o;
    o += round4(T + 1);
    L.ws = o;
    o = 0;
    L.nm = o;
    o += round4(W);
    L.ty = o;
    o += W;
    L.ord = o;
    o += W;
    L.lw = o;
    o += p.E * W;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.bytes = L.idx_b + (size_t)p.E * W;
    return L;
  }
  L.x = o;
  o += round4(C1 * W);
  L.dh = o;
  o += round4(D * W);
  L.w = o;
  o += p.ws ? T * C * round4(D) : 0;
  L.v = o;
  o += round4(T * 9 * D);
  L.nm = o;
  o += round4(W);
  L.ty = o;
  o += W;
  L.ord = o;
  o += W;
  L.tst = o;
  o += round4(T + 1);
  L.yp = L.kp = -1;
  if (p.st) {
    L.yp = o;
    o += round4(W * D);
    L.kp = o;
    o += round4((W * C1 + 3) / 4);
  }
  L.di = o;
  L.gs = L.di + round4(W * D);
  L.yk = L.gs + round4(W * D);
  L.da = o;
  o += max(p.st ? 3 * round4(W * D) : 0, round4(W * DP));
  L.lw = o;
  o += p.E * W;
  L.ds = L.x;
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + (p.E ? W : 0);
  L.bytes = L.idx_b + (size_t)p.E * W;
  return L;
}

// The block's nodes grouped by type (a counting sort, ascending node order
// within a type, so the per-type sums add in node order), for a CTA of any
// width: threads t < W rank their node among the nodes of its type
// before it, thread t counts types t, t + NT, ... Every thread must call it
// after the types are staged; it synchronises.
__device__ void order_nodes(const int* tys, int W, int T, int* ord, int* tst) {
  const int t = threadIdx.x;
  int ty = 0, rank = 0;
  if (t < W) {
    ty = tys[t];
    for (int m = 0; m < t; ++m) rank += tys[m] == ty;
  }
  for (int tt = t; tt < T; tt += blockDim.x) {
    int c = 0;
    for (int m = 0; m < W; ++m) c += tys[m] == tt;
    tst[tt + 1] = c;
  }
  __syncthreads();
  if (t == 0) {
    tst[0] = 0;
    for (int k = 0; k < T; ++k) tst[k + 1] += tst[k];
  }
  __syncthreads();
  if (t < W) ord[tst[ty] + rank] = t;
  __syncthreads();
}

// Four outputs j .. j + 3 (zero past D) of type ty's weights at column c:
// staged, one 16-byte read of wT; else four reads of w_stk [T * D][C].
__device__ __forceinline__ void w_quad(const float* wT, const float* __restrict__ w_stk, int ty,
                                       int c, int j, int C, int D, int D4, float (&w)[4]) {
  if (wT != nullptr) {
    ldv<4>(wT + (ty * C + c) * D4 + j, w);
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) w[u] = j + u < D ? w_stk[(size_t)(ty * D + j + u) * C + c] : 0.0f;
}

// K17: one reverse typed BN-training iteration over every block row, NT
// threads a CTA, one block row each; WIDE: the wide plan (ws its workspace).
template <int MAXF, int NT, bool ST, bool WIDE>
__global__ void __launch_bounds__(NT, NT == 256 ? 3 : 4)
bnT_bwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y_prev, const float* __restrict__ y_k,
               const float* __restrict__ agg, const int* __restrict__ types,
               const uint8_t* __restrict__ keep, const float* __restrict__ feats,
               const float* __restrict__ w_stk, const float* __restrict__ ds_in,
               const float* __restrict__ gsel, const float* __restrict__ bnv,
               const float* __restrict__ flag, const float* __restrict__ nm,
               float* __restrict__ ds, float* __restrict__ dw, float* __restrict__ dagg,
               float* __restrict__ red, int Bl, int W, int D, int F, int T,
               const uint8_t* __restrict__ acts, int mode, float da, float db, BnTBwdPlan p,
               float* ws) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const BnTBwdLayout L = bwdT_layout(W, D, F, T, p, WIDE);
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1, D4 = round4(D);
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  float* WB = WIDE ? ws + (size_t)r * L.ws : sm;  // x3, dh, dagg, ds, the types' starts
  float* X = WB + L.x;
  float* DH = WB + L.dh;
  float* wT = p.ws ? sm + L.w : nullptr;
  const float* v = WIDE ? bnv : sm + L.v;  // bnv [T][9][D], rows ops/bn.py::BNV_ROWS
  float* nms = sm + L.nm;
  int* tys = reinterpret_cast<int*>(sm + L.ty);
  int* ord = reinterpret_cast<int*>(sm + L.ord);
  int* tst = reinterpret_cast<int*>(WB + L.tst);
  float* DA = WB + L.da;
  float* lw = sm + L.lw;
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  // the block's rows, staged or in device memory
  const float* yp = ST ? sm + L.yp : y_prev + row0 * D;
  const float* di = ST ? sm + L.di : ds_in + row0 * D;
  const float* gs = ST ? sm + L.gs : gsel + row0 * D;
  const float* yk = ST ? sm + L.yk : y_k + row0 * D;
  const uint8_t* kg = mode != kNoDrop ? keep + row0 * C1 : nullptr;
  const uint8_t* kp = ST && kg != nullptr ? reinterpret_cast<const uint8_t*>(sm + L.kp) : kg;
  // thread (node n, part): NT / W threads a node (at W = 96 the last threads
  // take none), each taking columns c = part + tpn * i of x3 and a block of
  // JB outputs (or state columns) from j0 on, JB a multiple of 4, at most JT
  constexpr int JT = MAXF * kMaxW / NT;
  const int tpn = NT / W, n = t % W, part = t / W;
  const bool mine = part < tpn;
  const int JB = round4((D + tpn - 1) / tpn), j0 = part * JB, j1 = min(D, j0 + JB);

  // ---- staging, issued together, waited on once
  // wT [ty][c][j] = w_stk [ty * D + j][c], in w_stk's order
  for (int i = t; wT != nullptr && i < T * D4 * C; i += NT) {
    const int ty = i / (D4 * C), j = i / C % D4, c = i % C;
    if (j < D)
      cp_async4(wT + (ty * C + c) * D4 + j, w_stk + (size_t)(ty * D + j) * C + c);
    else
      wT[(ty * C + c) * D4 + j] = 0.0f;
  }
  if constexpr (!WIDE)
    for (int i = t; i < T * 9 * D; i += NT) cp_async4(sm + L.v + i, bnv + i);
  cp_rows(nms, nm + row0, W);
  for (int i = t; i < W; i += NT) tys[i] = types[row0 + i];
  if constexpr (ST) {
    cp_rows(sm + L.yp, y_prev + row0 * D, W * D);
    cp_rows(sm + L.di, ds_in + row0 * D, W * D);
    cp_rows(sm + L.gs, gsel + row0 * D, W * D);
    cp_rows(sm + L.yk, y_k + row0 * D, W * D);
    stage_rowsT(agg + row0 * D, W, D, X, D);
    stage_rowsT(feats + row0 * F, W, F, X, 2 * D);
    if (kg != nullptr) {
      uint8_t* kd = reinterpret_cast<uint8_t*>(sm + L.kp);
      if (reinterpret_cast<uintptr_t>(kg) % 16 == 0) {  // W * C1 is a multiple of 32
        for (int i = 16 * t; i < W * C1; i += 16 * NT)
          cp_async16(reinterpret_cast<float*>(kd + i), reinterpret_cast<const float*>(kg + i));
      } else {
        for (int i = t; i < W * C1; i += NT) kd[i] = kg[i];
      }
    }
  }
  if (p.E > 0) build_row_lists(adj, W, p.E, lw, idx, cnt);
  cp_async_wait_all();
  __syncthreads();
  order_nodes(tys, W, T, ord, tst);
  const int ty = tys[n];
  const float* vt = v + ty * 9 * D;  // this node's type's bnv rows

  // ---- the forward's dropped x3, transposed: s_prev (its type's affine,
  // rounded as the plain version: multiply, then add), agg, feats
  for (int c = part; mine && c < C1; c += tpn) {
    float x;
    if (c < D)
      x = __fadd_rn(__fmul_rn(yp[n * D + c], vt[c]), vt[D + c]);
    else if (ST)
      x = X[c * W + n];
    else
      x = c < 2 * D ? agg[(row0 + n) * D + c - D] : feats[(row0 + n) * F + c - 2 * D];
    X[c * W + n] = drop(mode, da, db, x, kp != nullptr && kp[n * C1 + c] != 0);
  }
  __syncthreads();

  // ---- dh = gy * act_t'(h) for outputs jc + i, JT at a time from jc = j0
  // (one chunk up to D 64), h from the node's type's rows in the per-node
  // order (bias first, then c ascending), gy from the state cotangent and
  // the type's BatchNorm backward coefficients
  auto form_dh = [&](int jc) {
    float h[JT];
#pragma unroll
    for (int q = 0; q < JT; q += 4) {
      float b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (jc + q < j1) w_quad(wT, w_stk, ty, C1, jc + q, C, D, D4, b4);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[q + u] = b4[u];
    }
    for (int c = 0; c < C1; ++c) {
      const float x = X[c * W + n];
#pragma unroll
      for (int q = 0; q < JT; q += 4) {
        if (jc + q < j1) {
          float w4[4];
          w_quad(wT, w_stk, ty, c, jc + q, C, D, D4, w4);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[q + u] = fmaf(w4[u], x, h[q + u]);
        }
      }
    }
    const float f = *flag, nmv = nms[n];
    const int act = acts[ty];
#pragma unroll
    for (int i = 0; i < JT; ++i) {
      const int j = jc + i;
      if (j < j1) {
        const int e = n * D + j;
        const float g = di[e] + f * gs[e];
        const float xk = (yk[e] - vt[2 * D + j]) * vt[3 * D + j];
        DH[j * W + n] = (vt[4 * D + j] * g - nmv * (vt[5 * D + j] + xk * vt[6 * D + j])) *
                        act_grad(act, h[i]);
      }
    }
  };
  if constexpr (WIDE) {
    for (int jc = j0; mine && jc < j1; jc += JT) form_dh(jc);
  } else if (mine && j0 < D) {
    form_dh(j0);
  }
  __syncthreads();

  // ---- dx = dh @ [Ws | Wa] of the node's type through the dropout's
  // derivative a * keep, for state columns j0 + i, j ascending (four a
  // 16-byte read of wT); dagg into DA (the late region: ds_in, gsel and y_k
  // are read). Wide: columns jc + i, JT at a time, dh read from DH, dxs
  // parked in the ds rows
  float dxs[JT];
  float* DS = WB + L.ds;
  if constexpr (WIDE) {
    for (int jc = j0; mine && jc < j1; jc += JT) {
#pragma unroll
      for (int i = 0; i < JT; ++i) {
        const int d = jc + i;
        if (d < j1) {
          float ss = 0.0f, sa = 0.0f;
          for (int q = 0; q < D; q += 4) {
            float ws4[4], wa4[4];
            w_quad(wT, w_stk, ty, d, q, C, D, D4, ws4);
            w_quad(wT, w_stk, ty, D + d, q, C, D, D4, wa4);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float dhv = q + u < D ? DH[(q + u) * W + n] : 0.0f;
              ss = fmaf(dhv, ws4[u], ss);
              sa = fmaf(dhv, wa4[u], sa);
            }
          }
          DS[n * DP + d] = ss * drop_grad(mode, da, kp != nullptr && kp[n * C1 + d] != 0);
          DA[n * DP + d] = sa * drop_grad(mode, da, kp != nullptr && kp[n * C1 + D + d] != 0);
        }
      }
    }
  } else {
    float dh[MAXF];
#pragma unroll
    for (int j = 0; j < MAXF; ++j) dh[j] = mine && j < D ? DH[j * W + n] : 0.0f;
#pragma unroll
    for (int i = 0; i < JT; ++i) {
      const int d = j0 + i;
      dxs[i] = 0.0f;
      if (mine && d < j1) {
        float ss = 0.0f, sa = 0.0f;
#pragma unroll
        for (int q = 0; q < MAXF; q += 4) {
          if (q < D) {
            float ws[4], wa[4];
            w_quad(wT, w_stk, ty, d, q, C, D, D4, ws);
            w_quad(wT, w_stk, ty, D + d, q, C, D, D4, wa);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              ss = fmaf(dh[q + u], ws[u], ss);
              sa = fmaf(dh[q + u], wa[u], sa);
            }
          }
        }
        dxs[i] = ss * drop_grad(mode, da, kp != nullptr && kp[n * C1 + d] != 0);
        DA[n * DP + d] = sa * drop_grad(mode, da, kp != nullptr && kp[n * C1 + D + d] != 0);
      }
    }
  }

  // ---- dw [T * D][C] = dh^T @ [x3 | 1] over each type's nodes: work item
  // (type, quad of 4 outputs, quad of 4 columns), the type's nodes in their
  // counting-sorted order (ascending), so every plan and every launch adds
  // the same terms in the same order
  const int CQ = (C + 3) / 4, JQ = (D + 3) / 4, nq = JQ * CQ;
  float* dw_r = dw + (size_t)r * T * D * C;
  for (int wi = t; wi < T * nq; wi += NT) {
    const int tt = wi / nq, qq = wi % nq;
    const int jq = 4 * (qq / CQ), c0 = 4 * (qq % CQ);
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] = 0.0f;
    for (int k = tst[tt]; k < tst[tt + 1]; ++k) {
      const int m = ord[k];
      float hv[4], xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) hv[u] = DH[min(jq + u, D - 1) * W + m];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = c0 + i < C1 ? X[(c0 + i) * W + m] : 1.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[u][i] = fmaf(hv[u], xv[i], acc[u][i]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (jq + u < D && c0 + i < C) dw_r[(size_t)(tt * D + jq + u) * C + c0 + i] = acc[u][i];
  }
  __syncthreads();  // X and dh are read; DA is full

  // ---- ds = dxs + adjT @ dagg, row n's entries in order (each read once for
  // the block of columns), into the freed X (wide: into its ds rows, JT
  // columns at a time)
  auto form_ds = [&](int jc) {
    float acc[JT];
#pragma unroll
    for (int i = 0; i < JT; ++i) acc[i] = 0.0f;
    auto add = [&](float a, int m) {
#pragma unroll
      for (int i = 0; i < JT; ++i)
        if (jc + i < j1) acc[i] = fmaf(a, DA[m * DP + jc + i], acc[i]);
    };
    const int c = p.E > 0 ? cnt[n] : W + 1;
    if (c <= p.E) {
      for (int e = 0; e < c; ++e) add(lw[e * W + n], idx[e * W + n]);
    } else {
      for (int m = 0; m < W; ++m) add(adj[(size_t)n * W + m], m);
    }
#pragma unroll
    for (int i = 0; i < JT; ++i)
      if (jc + i < j1) DS[n * DP + jc + i] = (WIDE ? DS[n * DP + jc + i] : dxs[i]) + acc[i];
  };
  if constexpr (WIDE) {
    for (int jc = j0; mine && jc < j1; jc += JT) form_ds(jc);
  } else if (mine && j0 < D) {
    form_ds(j0);
  }
  __syncthreads();

  // ---- ds and dagg out; the next reverse step's per-type reduction partials
  // (sum ds, sum ds * x_hat_prev) over each type's nodes in sorted order,
  // x_hat_prev from the type's rows (padded nodes count in type 0, their ds 0)
  for (int i = t; i < W * D; i += NT) {
    const int m = i / D, d = i % D;
    ds[row0 * D + i] = DS[m * DP + d];
    dagg[row0 * D + i] = DA[m * DP + d];
  }
  for (int o = t; o < T * D; o += NT) {
    const int tt = o / D, d = o % D;
    const float* vr = v + tt * 9 * D;
    float s0 = 0.0f, s1 = 0.0f;
    for (int k = tst[tt]; k < tst[tt + 1]; ++k) {
      const int m = ord[k];
      const float dsv = DS[m * DP + d];
      s0 += dsv;
      s1 = fmaf(dsv, (yp[m * D + d] - vr[7 * D + d]) * vr[8 * D + d], s1);
    }
    red[((size_t)r * T + tt) * 2 * D + d] = s0;
    red[((size_t)r * T + tt) * 2 * D + D + d] = s1;
  }
}

// ---- K16

// The first is the composite recipe's (T = 4, D 14, F 3: 49,568 bytes); the
// second leaves weights too large for a CTA in device memory; the last fits
// every shape the per-node K16 took (ops/typed.py::_BNT_FWD_PLANS mirrors
// the list).
constexpr BnTFwdPlan kBnTFwdPlans[] = {{256, 16, 1, 1}, {256, 16, 1, 0}, {128, 0, 0, 0}};
// the wide plan: 256 threads with the lists, nothing staged
constexpr BnTFwdPlan kBnTFwdWide = {256, 16, 0, 0};

// Float offsets of K16's shared memory (bytes for the list counts, sources
// and the list build's scratch, after the floats), each region a multiple of
// 16 bytes: x3 X [C1][W] (transposed; y1 and y2 first), with ws the stacked
// weights transposed wT [T][C][D4] (D4 = D rounded up to 4, zero past D; row
// C1 of a type its bias), the per-type affines [4][T][D], nm [W], the node
// types, the nodes ordered by type and the types' starts (ints [W], [W],
// [T + 1]), the row buffer [W][D | 1] (rT, then agg, then y), with st the
// keep bytes [W][C1], the lists [E][W]. The wide plan: in a block row's
// workspace slice of ws floats x3, the row buffer and the types' starts
// [T + 1] (ints); in shared memory nm, the types and their order, the lists,
// then the bytes.
struct BnTFwdLayout {
  int x, w, aff, nm, ty, ord, tst, ab, kp, lw, ws;
  size_t cnt_b, idx_b, part_b, bytes;
};

__host__ __device__ inline BnTFwdLayout fwdT_layout(int W, int D, int F, int T,
                                                    const BnTFwdPlan& p, bool wide = false) {
  BnTFwdLayout L{};
  const int C1 = 2 * D + F;
  int o = 0;
  if (wide) {
    L.w = L.aff = L.kp = -1;
    L.x = o;
    o += round4(C1 * W);
    L.ab = o;
    o += round4(W * (D | 1));
    L.tst = o;
    o += round4(T + 1);
    L.ws = o;
    o = 0;
    L.nm = o;
    o += round4(W);
    L.ty = o;
    o += W;
    L.ord = o;
    o += W;
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
  o += p.ws ? T * (C1 + 1) * round4(D) : 0;
  L.aff = o;
  o += round4(4 * T * D);
  L.nm = o;
  o += round4(W);
  L.ty = o;
  o += W;
  L.ord = o;
  o += W;
  L.tst = o;
  o += round4(T + 1);
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
  return L;
}

// K16: one typed BN-training iteration over every block row, NT threads a
// CTA, one block row each; WIDE: the wide plan (ws its workspace).
template <int MAXF, int NT, bool ST, bool WIDE>
__global__ void __launch_bounds__(NT, 3)
bnT_fwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y1, const float* __restrict__ y2,
               const float* __restrict__ aff, const int* __restrict__ types,
               const uint8_t* __restrict__ keep, const float* __restrict__ rT,
               const float* __restrict__ feats, const float* __restrict__ w_stk,
               const float* __restrict__ nm, float* __restrict__ y, float* __restrict__ agg,
               float* __restrict__ marg, float* __restrict__ msum, int Bl, int W, int D, int F,
               int T, float thr, const uint8_t* __restrict__ acts, int mode, float da, float db,
               BnTFwdPlan p, float* ws) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const BnTFwdLayout L = fwdT_layout(W, D, F, T, p, WIDE);
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1, D4 = round4(D);
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  float* WB = WIDE ? ws + (size_t)r * L.ws : sm;  // x3, the row buffer, the types' starts
  float* X = WB + L.x;
  float* wT = p.ws ? sm + L.w : nullptr;
  const float* v = WIDE ? aff : sm + L.aff;  // [scale1; shift1; scale2; shift2] x [T][D]
  float* nms = sm + L.nm;
  int* tys = reinterpret_cast<int*>(sm + L.ty);
  int* ord = reinterpret_cast<int*>(sm + L.ord);
  int* tst = reinterpret_cast<int*>(WB + L.tst);
  float* A = WB + L.ab;  // [W][DP]: rT, then agg, then y
  float* lw = sm + L.lw;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;
  const uint8_t* kg = mode != kNoDrop ? keep + row0 * C1 : nullptr;
  const bool kst = ST && kg != nullptr && reinterpret_cast<uintptr_t>(kg) % 16 == 0;

  // ---- staging, issued together, waited on once
  // wT [ty][c][j] = w_stk [ty * D + j][c], in w_stk's order
  for (int i = t; wT != nullptr && i < T * D4 * C; i += NT) {
    const int ty = i / (D4 * C), j = i / C % D4, c = i % C;
    if (j < D)
      cp_async4(wT + (ty * C + c) * D4 + j, w_stk + (size_t)(ty * D + j) * C + c);
    else
      wT[(ty * C + c) * D4 + j] = 0.0f;
  }
  cp_rows(nms, nm + row0, W);
  for (int i = t; i < W; i += NT) tys[i] = types[row0 + i];
  if constexpr (WIDE) {
    stage_rowsT<true>(y1 + row0 * D, W, D, X, 0);
    stage_rowsT<true>(y2 + row0 * D, W, D, X, D);
    stage_rowsT<true>(feats + row0 * F, W, F, X, 2 * D);
    if (rT != nullptr)
      for (int i = t; i < W * D; i += NT) A[(i / D) * DP + i % D] = rT[row0 * D + i];
  } else {
    for (int i = t; i < 4 * T * D; i += NT) cp_async4(sm + L.aff + i, aff + i);
    stage_rowsT(y1 + row0 * D, W, D, X, 0);  // x3 rows [0, D): y1, then s
    stage_rowsT(y2 + row0 * D, W, D, X, D);  // rows [D, 2D): y2, then agg
    stage_rowsT(feats + row0 * F, W, F, X, 2 * D);
    if (rT != nullptr)
      for (int i = t; i < W * D; i += NT) cp_async4(A + (i / D) * DP + i % D, rT + row0 * D + i);
  }
  if (kst)  // W * C1 is a multiple of 32
    for (int i = 16 * t; i < W * C1; i += 16 * NT)
      cp_async16(sm + L.kp + i / 4, reinterpret_cast<const float*>(kg + i));
  if (p.E > 0) build_col_lists(adj, W, p.E, lw, idx, cnt, bytes + L.part_b);
  cp_async_wait_all();
  __syncthreads();
  order_nodes(tys, W, T, ord, tst);
  const uint8_t* kp = kst ? reinterpret_cast<const uint8_t*>(sm + L.kp) : kg;

  // ---- s and s_old through the node's type's affines (multiply, then add,
  // as the plain version rounds them), the movement test one thread a node,
  // d ascending
  for (int n = t; n < W; n += NT) {
    const int ty = tys[n];
    const float* sc1 = v + ty * D;
    const float* sh1 = v + (T + ty) * D;
    const float* sc2 = v + (2 * T + ty) * D;
    const float* sh2 = v + (3 * T + ty) * D;
    float dist2 = 0.0f, norm2 = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float s = __fadd_rn(__fmul_rn(X[d * W + n], sc1[d]), sh1[d]);
      const float so = __fadd_rn(__fmul_rn(X[(D + d) * W + n], sc2[d]), sh2[d]);
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

  // ---- y = act_t(h), h from the node's own type's rows in the per-node
  // order (bias first, then c ascending), outputs jc + i of node n, JT at a
  // time from jc = j0 (one chunk up to D 64), four a 16-byte read of wT; into
  // the row buffer (agg is out)
  constexpr int JT = MAXF * kMaxW / NT;
  const int tpn = NT / W, n = t % W, part = t / W;
  const int JB = round4((D + tpn - 1) / tpn), j0 = part * JB, j1 = min(D, j0 + JB);
  auto form_y = [&](int jc) {
    const int ty = tys[n];
    float h[JT];
#pragma unroll
    for (int q = 0; q < JT; q += 4) {
      float b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (jc + q < j1) w_quad(wT, w_stk, ty, C1, jc + q, C, D, D4, b4);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[q + u] = b4[u];
    }
    for (int c = 0; c < C1; ++c) {
      const float x = X[c * W + n];
#pragma unroll
      for (int q = 0; q < JT; q += 4) {
        if (jc + q < j1) {
          float w4[4];
          w_quad(wT, w_stk, ty, c, jc + q, C, D, D4, w4);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[q + u] = fmaf(w4[u], x, h[q + u]);
        }
      }
    }
    const int act = acts[ty];
#pragma unroll
    for (int i = 0; i < JT; ++i)
      if (jc + i < j1) A[n * DP + jc + i] = activate(act, h[i]);
  };
  if constexpr (WIDE) {
    for (int jc = j0; part < tpn && jc < j1; jc += JT) form_y(jc);
  } else if (part < tpn && j0 < D) {
    form_y(j0);
  }
  __syncthreads();

  // ---- y out; msum, each type's nodes in their counting-sorted order
  for (int i = t; i < W * D; i += NT) y[row0 * D + i] = A[(i / D) * DP + i % D];
  for (int o = t; o < T * D; o += NT) {
    const int tt = o / D, d = o % D;
    float s = 0.0f;
    for (int k = tst[tt]; k < tst[tt + 1]; ++k) {
      const int m = ord[k];
      s = fmaf(A[m * DP + d], nms[m], s);
    }
    msum[(size_t)r * T * D + o] = s;
  }
}

using BnTFwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const int*, const uint8_t*, const float*, const float*, const float*,
                          const float*, float*, float*, float*, float*, int, int, int, int, int,
                          float, const uint8_t*, int, float, float, BnTFwdPlan, float*);
using BnTBwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const int*, const uint8_t*, const float*, const float*, const float*,
                          const float*, const float*, const float*, const float*, float*, float*,
                          float*, float*, int, int, int, int, int, const uint8_t*, int, float,
                          float, BnTBwdPlan, float*);

template <int MAXF>
BnTFwdFn fwd_variant(const BnTFwdPlan& p) {
  return p.st ? bnT_fwd_kernel<MAXF, 256, true, false> : bnT_fwd_kernel<MAXF, 128, false, false>;
}

template <int MAXF>
BnTBwdFn bwd_variant(const BnTBwdPlan& p) {
  return p.st ? bnT_bwd_kernel<MAXF, 256, true, false> : bnT_bwd_kernel<MAXF, 128, false, false>;
}

}  // namespace

#if defined(GNN_WIDE_TU)

namespace gnn {
// K16's and K17's wide-plan instantiations (bn_typed_wide.cu).
BnTFwdFn bnT_fwd_wide() { return bnT_fwd_kernel<64, 256, false, true>; }
BnTBwdFn bnT_bwd_wide() { return bnT_bwd_kernel<64, 256, false, true>; }
}  // namespace gnn

#elif defined(GNN_MAXF64_TU)

namespace gnn {
// K16's and K17's staged instantiations at register width 64 (bn_typed_64.cu).
BnTFwdFn bnT_fwd_variant64(const BnTFwdPlan& p) { return fwd_variant<64>(p); }
BnTBwdFn bnT_bwd_variant64(const BnTBwdPlan& p) { return bwd_variant<64>(p); }
}  // namespace gnn

#else

namespace gnn {
BnTFwdFn bnT_fwd_wide();
BnTBwdFn bnT_bwd_wide();
BnTFwdFn bnT_fwd_variant64(const BnTFwdPlan& p);
BnTBwdFn bnT_bwd_variant64(const BnTBwdPlan& p);
}  // namespace gnn

namespace {

bool shape_ok(int R, int Bl, int W, int D, int F, int T) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && T >= 1;
}

// The staged plans' range: D up to 64 (their register arrays), T up to 32.
bool staged_ok(int D, int T) { return width_class(D) != 0 && T <= 32; }

// The first plan of `plans` (the wide plan at index kBnTWideIndex) that fits
// a CTA at this shape, or plan `force` (>= 0) if it fits: its index (-1 if
// none), *bytes (the last plan tried), *ws the workspace floats a block row.
template <typename Plan, typename Layout, size_t N>
int pick_typed(const Plan (&plans)[N], const Plan& widep, Layout (*layout)(int, int, int, int,
                                                                            const Plan&, bool),
               int W, int D, int F, int T, int force, Plan* p, size_t* bytes, int* ws) {
  static_assert(N == kBnTWideIndex, "the wide plan follows the staged ones");
  for (int i = force >= 0 ? force : 0; i <= kBnTWideIndex; ++i) {
    const bool wide = i == kBnTWideIndex;
    if (wide || staged_ok(D, T)) {
      const Plan plan = wide ? widep : plans[i];
      const Layout L = layout(W, D, F, T, plan, wide);
      *bytes = L.bytes;
      if (*bytes <= (size_t)kMaxSmemBytes) {
        *p = plan;
        *ws = wide ? L.ws : 0;
        return i;
      }
    }
    if (force >= 0) break;
  }
  return -1;
}

int g_force_fwd = -1;  // gnn_bnT_forward_force_plan

// K16's kernel and plan for a shape: the first plan of kBnTFwdPlans that
// fits a CTA, else the wide plan (index kBnTWideIndex), or plan g_force_fwd
// (>= 0) if it fits; nullptr (bytes: the last plan's) if none. *ws: the
// plan's workspace floats a block row.
BnTFwdFn pick_fwd(int W, int D, int F, int T, BnTFwdPlan* p, size_t* bytes, int* index,
                  int* ws) {
  *index = pick_typed(kBnTFwdPlans, kBnTFwdWide, fwdT_layout, W, D, F, T, g_force_fwd, p, bytes,
                      ws);
  if (*index < 0) return nullptr;
  if (*index == kBnTWideIndex) return bnT_fwd_wide();
  return D <= 16 ? fwd_variant<16>(*p) : D <= 32 ? fwd_variant<32>(*p) : bnT_fwd_variant64(*p);
}

int g_force = -1;  // gnn_bnT_backward_force_plan

// K17's kernel and plan for a shape, as pick_fwd's (kBnTBwdPlans, g_force).
BnTBwdFn pick_bwd(int W, int D, int F, int T, BnTBwdPlan* p, size_t* bytes, int* index,
                  int* ws) {
  *index = pick_typed(kBnTBwdPlans, kBnTBwdWide, bwdT_layout, W, D, F, T, g_force, p, bytes, ws);
  if (*index < 0) return nullptr;
  if (*index == kBnTWideIndex) return bnT_bwd_wide();
  return D <= 16 ? bwd_variant<16>(*p) : D <= 32 ? bwd_variant<32>(*p) : bnT_bwd_variant64(*p);
}

}  // namespace

extern "C" {

// adj_loop [Bl, W, W] (null when Bl == 0), adj_dep [R - Bl, W, W] (null when
// Bl == R); y1, y2, rT (nullable) [R, W, D]; aff [2, 2, T, D]; types int32
// [R, W]; keep uint8 [R, W, 2D + F] (null when mode == 0); feats [R, W, F];
// w_stk [T * D, 2D + F + 1]; nm [R, W]; acts uint8 [T] (device memory), type
// t's activation code -> y, agg [R, W, D], marg [R, W], msum [R, T, D]; ws:
// the wide plan's workspace, R slices of gnn_bnT_forward_workspace floats
// (null for a staged plan). Returns a cudaError_t code.
int gnn_bnT_forward(const float* adj_loop, const float* adj_dep, const float* y1,
                    const float* y2, const float* aff, const int* types, const uint8_t* keep,
                    const float* rT, const float* feats, const float* w_stk, const float* nm,
                    float* y, float* agg, float* marg, float* msum, int R, int Bl, int W, int D,
                    int F, int T, float thr, const uint8_t* acts, int mode, float da, float db,
                    void* stream, float* ws) {
  if (!shape_ok(R, Bl, W, D, F, T) || acts == nullptr) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  BnTFwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnTFwdFn fn = pick_fwd(W, D, F, T, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, y, agg, marg, msum, Bl,
      W, D, F, T, thr, acts, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block row the plan gnn_bnT_forward picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_bnT_forward_workspace(int W, int D, int F, int T) {
  BnTFwdPlan p;
  size_t bytes;
  int index, wsf;
  return pick_fwd(W, D, F, T, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bnT_forward launches for
// this shape. Returns a cudaError_t code.
int gnn_bnT_forward_info(int W, int D, int F, int T, int* out) {
  BnTFwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnTFwdFn fn = pick_fwd(W, D, F, T, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` of kBnTFwdPlans (3: the wide plan) from now on, where
// it fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_bnT_forward_force_plan(int index) { g_force_fwd = index; }

// As gnn_bnT_forward, plus y_prev, y_k, agg, ds_in, gsel [R, W, D]; bnv
// [T, 9, D]; flag a device float (0 or 1) -> ds, dagg [R, W, D], dw
// [R, T * D, 2D + F + 1], red [R, T, 2, D]; ws: the wide plan's workspace, R
// slices of gnn_bnT_backward_workspace floats (null for a staged plan).
// Returns a cudaError_t code.
int gnn_bnT_backward(const float* adj_loop, const float* adj_dep, const float* y_prev,
                     const float* y_k, const float* agg, const int* types, const uint8_t* keep,
                     const float* feats, const float* w_stk, const float* ds_in,
                     const float* gsel, const float* bnv, const float* flag, const float* nm,
                     float* ds, float* dw, float* dagg, float* red, int R, int Bl, int W, int D,
                     int F, int T, const uint8_t* acts, int mode, float da, float db,
                     void* stream, float* ws) {
  if (!shape_ok(R, Bl, W, D, F, T) || acts == nullptr) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  BnTBwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnTBwdFn fn = pick_bwd(W, D, F, T, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk, ds_in, gsel, bnv, flag, nm,
      ds, dw, dagg, red, Bl, W, D, F, T, acts, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block row the plan gnn_bnT_backward picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_bnT_backward_workspace(int W, int D, int F, int T) {
  BnTBwdPlan p;
  size_t bytes;
  int index, wsf;
  return pick_bwd(W, D, F, T, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bnT_backward launches for
// this shape. Returns a cudaError_t code.
int gnn_bnT_backward_info(int W, int D, int F, int T, int* out) {
  BnTBwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnTBwdFn fn = pick_bwd(W, D, F, T, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` of kBnTBwdPlans (3: the wide plan) from now on, where it
// fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_bnT_backward_force_plan(int index) { g_force = index; }

}  // extern "C"

#endif  // GNN_WIDE_TU, GNN_MAXF64_TU
