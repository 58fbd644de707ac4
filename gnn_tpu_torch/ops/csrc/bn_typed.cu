// Typed BatchNorm-training propagation kernels of composite (per-node-type)
// GNNs for Hopper (sm_90a), in plain fp32 on the CUDA cores (no TF32, no
// bf16).
//
// Replaces gnn_tpu/ops/pallas_typed.py:
//   K16 _bnT_fwd_kernel (launched by _bnT_fwd_call) -> gnn_bnT_forward
//   K17 _bnT_bwd_kernel (launched by _bnT_bwd_call) -> gnn_bnT_backward
//
// They are K1/K2 (bn_train.cu) with a node type per node: node n of type
// t(n) normalizes with type t(n)'s affine, meets only rows [t*D, (t+1)*D) of
// the stacked weights w_stk [T*D, C] (C = 2D + F + 1, rows [Ws|Wa|Wf|b] of
// each type) and type t(n)'s activation, and the moment and reduction sums
// are split by type:
//   K16  s = y1 * scale1[t] + shift1[t], s_old = y2 * scale2[t] + shift2[t]
//        marg, agg = adjT^T @ s (+ rT), x3 = drop([s | agg | feats]) as K1
//        y = act_t(w_stk[t] @ [x3; 1]),  msum[t'] = sum over type-t' nodes of y * nm
//   K17  gy = bnv[t][4] * (ds_in + flag * gsel) - nm * (bnv[t][5] + x_hat_k * bnv[t][6])
//        dh = gy * act_t'(h),  dw[t rows] += dh^T @ [x3; 1]   (per-block partial)
//        dagg = (dh @ Wa[t]) * dmask,  ds = (dh @ Ws[t]) * dmask + adjT @ dagg
//        red[t'] = (sum ds, sum ds * x_hat_prev) over type-t' nodes
// Types are indices (uint8, 0 on padded nodes). gnn_tpu multiplies every node
// by all T weight slabs and selects with a one-hot mask; the rows of other
// types are multiplied by 0 there, so computing only the node's own rows is
// the same function, and the dense work stays K1's whatever T is. Padded
// nodes select type 0 for the state update, as the raw one-hot does; nm
// masks them out of margins, moments and the moment term of gy, and red
// counts them in type 0 (gnn_tpu's raw type mask; their ds is 0).
//
// K16's design, as K1's: one CTA per block row, one thread per node
// (blockDim == W), the block adjacency staged in shared memory at row stride
// W + 1; sums over nodes leave as per-block partials that the caller adds up
// in order (no float atomics: results repeat bit for bit). The per-type
// coefficient rows, the node types and, when they still fit the 227 KB a CTA
// may use, the stacked weights are staged in shared memory; otherwise each
// thread reads its type's weight rows through the L1/L2 caches. The per-type
// moment sums run over each type's nodes only: the block's nodes are
// counting-sorted by type once, so they cost K1's node loops whatever T is.
//
// K17's design is K2's (bn_train.cu, tile2.cuh's staging and lists) with
// per-type weights, one launch over every block row:
// - no resident adjacency: each row's nonzero entries go into a compact list
//   at staging ([8][W] weights and uint8 destinations, built from coalesced
//   16-byte reads, tile2.cuh::build_row_lists), so ds = dxs + adjT @ dagg
//   costs 2*D an arc, not 2*D*W a node (a row of more than 8 entries is
//   read from device memory, every entry, so a dense block is exact);
// - the rows (y_prev, ds_in, gsel, y_k node-major by 16-byte copies; agg and
//   feats transposed into x3's rows), the stacked weights transposed
//   (wT [T][C][D4]), the per-type bnv rows, nm, the types and the keep bytes
//   are staged with cp.async, issued together and waited on once; weights
//   that do not fit are read through the L1/L2 caches (the same values into
//   the same FMAs in the same order);
// - h recomputed per node from its own type's rows in dense_aug's order
//   (bias first, then c ascending), NT / W threads a node taking every
//   (NT / W)-th output; dx = dh @ [Ws | Wa] from the transposed weights, four
//   outputs a 16-byte read;
// - dw [T * D][C] and red sum each type's nodes in their counting-sorted
//   order (ord, tst), one work item (type, 4 outputs x 4 columns) a thread:
//   the sums are added in per-type node order, so every plan gives the same
//   bits, a repeat launch is bit-identical, and the outputs are bit for bit
//   the per-node K17's; mixed per-type activations select their derivative
//   per node (their speed is not the target). Splitting each type's nodes
//   into two halves summed on two threads (the CTA's other half idles here,
//   36% of the kernel's cycles, tools/phase_marks.py) ran 2% slower.
// The plans (kBnTBwdPlans: threads, list room, rows staged, weights staged)
// are mirrored by ops/typed.py::_bnT_bwd_plan; the last (128 threads, no
// staging, no lists) fits every shape the per-node K17 took.
//
// Bound: as K1/K2, a launch reads every block's adjacency once (64 KiB at
// W = 128), which dominates the bytes moved; the types add W bytes a block
// and do not grow with T. The least time is set by bytes. K16 stages the
// adjacency synchronously and contracts it densely, so its time is set by
// shared-memory traffic and FMAs, as K1's.

#include "tile2.cuh"

namespace {

using namespace gnn;

// Float offsets of the shared-memory buffers; w last, so the layout without
// staged weights is a prefix.
struct Layout {
  int adj;    // [W][W + 1]  adjT[src][dst]
  int x;      // [W][XP]     x3 rows [s | agg | feats], XP = (2D + F) | 1
  int rows;   // [W][DP]     staging of [W, D] row blocks, DP = D | 1
  int vec;    // aff [2][2][T][D]
  int nm;     // [W]         node mask
  int ty;     // [W]         node types (int)
  int ord;    // [W]         the block's nodes by type, ascending within a type
  int tst;    // [T + 1]     type t's nodes are ord[tst[t] .. tst[t + 1])
  int keep;   // W * (2D + F) bytes of keep bits
  int w;      // [T * D][C]  w_stk, when staged
  int total;
};

__host__ __device__ Layout layout(int W, int D, int F, int T, bool stage_w) {
  const int C = 2 * D + F + 1;
  Layout l;
  int o = 0;
  l.adj = o;
  o += W * (W + 1);
  l.x = o;
  o += W * ((C - 1) | 1);
  l.rows = o;
  o += W * (D | 1);
  l.vec = o;
  o += 4 * T * D;
  l.nm = o;
  o += W;
  l.ty = o;
  o += W;
  l.ord = o;
  o += W;
  l.tst = o;
  o += T + 1;
  l.keep = o;
  o += (W * (C - 1) + 3) / 4;
  l.w = o;
  if (stage_w) o += T * D * C;
  l.total = o;
  return l;
}

__device__ __forceinline__ int act_of(unsigned long long acts, int t) {
  return static_cast<int>((acts >> (2 * t)) & 3ull);
}

// K16's operands, staged once per CTA: adjacency, (w_stk),
// the per-type coefficient rows, node mask, node types, keep bits and the
// feats columns of x3. Returns this CTA's weight base (shared or device).
__device__ const float* stage_typed(float* sm, const Layout& L, const float* adj_loop,
                                    const float* adj_dep, int Bl, const float* __restrict__ w_stk,
                                    bool stage_w, const float* __restrict__ vec, int vec_n,
                                    const float* __restrict__ nm,
                                    const uint8_t* __restrict__ types,
                                    const uint8_t* __restrict__ keep,
                                    const float* __restrict__ feats, int W, int D, int F, int T,
                                    int mode) {
  const size_t row0 = (size_t)blockIdx.x * W;
  const int C = 2 * D + F + 1;
  stage_adj(block_adj(adj_loop, adj_dep, Bl, W), W, sm + L.adj);
  if (stage_w)
    for (int i = threadIdx.x; i < T * D * C; i += blockDim.x) sm[L.w + i] = w_stk[i];
  for (int i = threadIdx.x; i < vec_n; i += blockDim.x) sm[L.vec + i] = vec[i];
  sm[L.nm + threadIdx.x] = nm[row0 + threadIdx.x];
  reinterpret_cast<int*>(sm + L.ty)[threadIdx.x] = types[row0 + threadIdx.x];
  if (mode != kNoDrop) {
    uint8_t* kp = reinterpret_cast<uint8_t*>(sm + L.keep);
    const uint8_t* kg = keep + row0 * (C - 1);
    for (int i = threadIdx.x; i < W * (C - 1); i += blockDim.x) kp[i] = kg[i];
  }
  stage_in(feats + row0 * F, W, F, sm + L.x, (C - 1) | 1, 2 * D);
  return stage_w ? sm + L.w : w_stk;
}

// The block's nodes grouped by type (a counting sort, ascending node order
// within a type, so the per-type sums below add in node order): each node
// counts the nodes of its type before it, threads t < T count type t. Every
// thread must call it after the types are staged; it synchronises.
__device__ void order_by_type(const int* tys, int W, int T, int* ord, int* tst) {
  const int t = threadIdx.x, ty = tys[t];
  int rank = 0;
  for (int m = 0; m < t; ++m) rank += tys[m] == ty;
  if (t < T) {
    int c = 0;
    for (int m = 0; m < W; ++m) c += tys[m] == t;
    tst[t + 1] = c;
  }
  __syncthreads();
  if (t == 0) {
    tst[0] = 0;
    for (int k = 0; k < T; ++k) tst[k + 1] += tst[k];
  }
  __syncthreads();
  ord[tst[ty] + rank] = t;
  __syncthreads();
}

// K16: one typed BN-training iteration over every block row (row r < Bl
// reads adj_loop[r], the rest adj_dep[r - Bl]).
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
bnT_fwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y1, const float* __restrict__ y2,
               const float* __restrict__ aff, const uint8_t* __restrict__ types,
               const uint8_t* __restrict__ keep, const float* __restrict__ rT,
               const float* __restrict__ feats, const float* __restrict__ w_stk,
               const float* __restrict__ nm, float* __restrict__ y, float* __restrict__ agg,
               float* __restrict__ marg, float* __restrict__ msum, int Bl, int W, int D, int F,
               int T, float thr, unsigned long long acts, int mode, float da, float db,
               int stage_w) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const Layout L = layout(W, D, F, T, stage_w);
  const int C = 2 * D + F + 1, XP = (C - 1) | 1, DP = D | 1;
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = sm + L.adj;
  float* xs = sm + L.x;
  float* xrow = xs + t * XP;
  float* rows = sm + L.rows;
  const float* vec = sm + L.vec;  // [scale1; shift1; scale2; shift2] x [T][D]
  const float* nms = sm + L.nm;
  const int* tys = reinterpret_cast<const int*>(sm + L.ty);
  int* ord = reinterpret_cast<int*>(sm + L.ord);
  int* tst = reinterpret_cast<int*>(sm + L.tst);
  const uint8_t* krow = reinterpret_cast<const uint8_t*>(sm + L.keep) + t * (C - 1);

  const float* wbase = stage_typed(sm, L, adj_loop, adj_dep, Bl, w_stk, stage_w, aff, 4 * T * D,
                                   nm, types, keep, feats, W, D, F, T, mode);
  stage_in(y1 + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  order_by_type(tys, W, T, ord, tst);
  const int ty = tys[t];
  const float* sc1 = vec + ty * D;
  const float* sh1 = vec + (T + ty) * D;
  const float* sc2 = vec + (2 * T + ty) * D;
  const float* sh2 = vec + (3 * T + ty) * D;
  // s -> x3 columns [0, D); rounded as the plain version's multiply, then add
  for (int d = 0; d < D; ++d) xrow[d] = __fadd_rn(__fmul_rn(rows[t * DP + d], sc1[d]), sh1[d]);
  __syncthreads();
  stage_in(y2 + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  float dist2 = 0.0f, norm2 = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float so = __fadd_rn(__fmul_rn(rows[t * DP + d], sc2[d]), sh2[d]);
    const float diff = __fsub_rn(xrow[d], so);
    dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
    norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
  }
  marg[row0 + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[t] : 0.0f;
  __syncthreads();
  if (rT != nullptr) stage_in(rT + row0 * D, W, D, rows, DP, 0);
  __syncthreads();

  float acc[MAXF];
  aggregate_col<MAXF>(adj, W, xs, XP, D, acc);
  if (rT != nullptr) {
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) acc[d] += rows[t * DP + d];
  }
  __syncthreads();  // every thread is done with the s columns and rows
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      rows[t * DP + d] = acc[d];
      xrow[D + d] = acc[d];
    }
  }
  drop_row(xrow, krow, C - 1, mode, da, db);
  __syncthreads();
  stage_out(agg + row0 * D, W, D, rows, DP);

  float h[MAXF];
  dense_aug<MAXF>(wbase + (size_t)ty * D * C, xrow, D, C, h);
  __syncthreads();  // agg is out of rows
  const int act = act_of(acts, ty);
#pragma unroll
  for (int j = 0; j < MAXF; ++j)
    if (j < D) rows[t * DP + j] = activate(act, h[j]);
  __syncthreads();
  stage_out(y + row0 * D, W, D, rows, DP);
  // per-type moment sums over the block's real nodes, in node order
  for (int o = t; o < T * D; o += blockDim.x) {
    const int tt = o / D, d = o % D;
    float s = 0.0f;
    for (int k = tst[tt]; k < tst[tt + 1]; ++k) {
      const int n = ord[k];
      s = fmaf(rows[n * DP + d], nms[n], s);
    }
    msum[(size_t)r * T * D + o] = s;
  }
}

// ---- K17

// A K17 plan: threads a CTA, room of the row lists (0: the adjacency is read
// from device memory), whether the rows and keep bytes are staged, whether
// the stacked weights are staged (else read through the L1/L2 caches).
struct BnTBwdPlan {
  int nt, E, st, ws;
};

// The first is the composite recipe's (T = 4, D 14, F 3: 72,704 bytes, three
// CTAs of 256 threads an SM; lists of 8, where K2's hold 16, make room for
// the stacked weights); the second leaves weights too large for a CTA in
// device memory; the last fits every shape the per-node K17 took
// (ops/typed.py::_BNT_BWD_PLANS mirrors the list).
constexpr BnTBwdPlan kBnTBwdPlans[] = {{256, 8, 1, 1}, {256, 8, 1, 0}, {128, 0, 0, 0}};

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
struct BnTBwdLayout {
  int x, dh, w, v, nm, ty, ord, tst, yp, kp, di, gs, yk, da, lw, ds;
  size_t cnt_b, idx_b, bytes;
};

__host__ __device__ inline BnTBwdLayout bwdT_layout(int W, int D, int F, int T,
                                                    const BnTBwdPlan& p) {
  BnTBwdLayout L{};
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1;
  int o = 0;
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

// The block's nodes grouped by type as order_by_type groups them, for a CTA
// of any width: threads t < W rank their node among the nodes of its type
// before it, threads t < T count type t. Every thread must call it after
// the types are staged; it synchronises.
__device__ void order_nodes(const int* tys, int W, int T, int* ord, int* tst) {
  const int t = threadIdx.x;
  int ty = 0, rank = 0;
  if (t < W) {
    ty = tys[t];
    for (int m = 0; m < t; ++m) rank += tys[m] == ty;
  }
  if (t < T) {
    int c = 0;
    for (int m = 0; m < W; ++m) c += tys[m] == t;
    tst[t + 1] = c;
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
// threads a CTA, one block row each.
template <int MAXF, int NT, bool ST>
__global__ void __launch_bounds__(NT, NT == 256 ? 3 : 4)
bnT_bwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y_prev, const float* __restrict__ y_k,
               const float* __restrict__ agg, const uint8_t* __restrict__ types,
               const uint8_t* __restrict__ keep, const float* __restrict__ feats,
               const float* __restrict__ w_stk, const float* __restrict__ ds_in,
               const float* __restrict__ gsel, const float* __restrict__ bnv,
               const float* __restrict__ flag, const float* __restrict__ nm,
               float* __restrict__ ds, float* __restrict__ dw, float* __restrict__ dagg,
               float* __restrict__ red, int Bl, int W, int D, int F, int T,
               unsigned long long acts, int mode, float da, float db, BnTBwdPlan p) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const BnTBwdLayout L = bwdT_layout(W, D, F, T, p);
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1, D4 = round4(D);
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  float* X = sm + L.x;
  float* DH = sm + L.dh;
  float* wT = p.ws ? sm + L.w : nullptr;
  float* v = sm + L.v;  // bnv [T][9][D], rows ops/bn.py::BNV_ROWS
  float* nms = sm + L.nm;
  int* tys = reinterpret_cast<int*>(sm + L.ty);
  int* ord = reinterpret_cast<int*>(sm + L.ord);
  int* tst = reinterpret_cast<int*>(sm + L.tst);
  float* DA = sm + L.da;
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
  for (int i = t; i < T * 9 * D; i += NT) cp_async4(v + i, bnv + i);
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

  // ---- dh = gy * act_t'(h) for outputs j0 + i, h from the node's type's
  // rows in dense_aug's order (bias first, then c ascending), gy from the
  // state cotangent and the type's BatchNorm backward coefficients
  if (mine && j0 < D) {
    float h[JT];
#pragma unroll
    for (int q = 0; q < JT; q += 4) {
      float b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j0 + q < j1) w_quad(wT, w_stk, ty, C1, j0 + q, C, D, D4, b4);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[q + u] = b4[u];
    }
    for (int c = 0; c < C1; ++c) {
      const float x = X[c * W + n];
#pragma unroll
      for (int q = 0; q < JT; q += 4) {
        if (j0 + q < j1) {
          float w4[4];
          w_quad(wT, w_stk, ty, c, j0 + q, C, D, D4, w4);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[q + u] = fmaf(w4[u], x, h[q + u]);
        }
      }
    }
    const float f = *flag, nmv = nms[n];
    const int act = static_cast<int>((acts >> (2 * ty)) & 3ull);
#pragma unroll
    for (int i = 0; i < JT; ++i) {
      const int j = j0 + i;
      if (j < j1) {
        const int e = n * D + j;
        const float g = di[e] + f * gs[e];
        const float xk = (yk[e] - vt[2 * D + j]) * vt[3 * D + j];
        DH[j * W + n] = (vt[4 * D + j] * g - nmv * (vt[5 * D + j] + xk * vt[6 * D + j])) *
                        act_grad(act, h[i]);
      }
    }
  }
  __syncthreads();

  // ---- dx = dh @ [Ws | Wa] of the node's type through the dropout's
  // derivative a * keep, for state columns j0 + i, j ascending (four a
  // 16-byte read of wT); dagg into DA (the late region: ds_in, gsel and y_k
  // are read)
  float dxs[JT];
  {
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
  // the block of columns), into the freed X
  float* DS = sm + L.ds;
  if (mine && j0 < D) {
    float acc[JT];
#pragma unroll
    for (int i = 0; i < JT; ++i) acc[i] = 0.0f;
    auto add = [&](float a, int m) {
#pragma unroll
      for (int i = 0; i < JT; ++i)
        if (j0 + i < j1) acc[i] = fmaf(a, DA[m * DP + j0 + i], acc[i]);
    };
    const int c = p.E > 0 ? cnt[n] : W + 1;
    if (c <= p.E) {
      for (int e = 0; e < c; ++e) add(lw[e * W + n], idx[e * W + n]);
    } else {
      for (int m = 0; m < W; ++m) add(adj[(size_t)n * W + m], m);
    }
#pragma unroll
    for (int i = 0; i < JT; ++i)
      if (j0 + i < j1) DS[n * DP + j0 + i] = dxs[i] + acc[i];
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

bool shape_ok(int R, int Bl, int W, int D, int F, int T) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && T >= 1 && T <= 32 && width_class(D) != 0;
}

// Shared memory of a K16 launch: with the stacked weights when they fit a
// CTA, else without (ops/typed.py::typed_smem_bytes mirrors it).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int W, int D, int F, int T, size_t* bytes, int* stage_w) {
  *bytes = sizeof(float) * (size_t)layout(W, D, F, T, true).total;
  *stage_w = *bytes <= (size_t)kMaxSmemBytes;
  if (!*stage_w) *bytes = sizeof(float) * (size_t)layout(W, D, F, T, false).total;
  return set_smem(kernel, *bytes);
}

template <int MAXF>
cudaError_t launch_fwd(const float* adj_loop, const float* adj_dep, const float* y1,
                       const float* y2, const float* aff, const uint8_t* types,
                       const uint8_t* keep, const float* rT, const float* feats,
                       const float* w_stk, const float* nm, float* y, float* agg, float* marg,
                       float* msum, int R, int Bl, int W, int D, int F, int T, float thr,
                       unsigned long long acts, int mode, float da, float db,
                       cudaStream_t stream) {
  size_t bytes;
  int stage_w;
  cudaError_t err = prepare(bnT_fwd_kernel<MAXF>, W, D, F, T, &bytes, &stage_w);
  if (err != cudaSuccess) return err;
  bnT_fwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y1, y2, aff, types, keep, rT,
                                                 feats, w_stk, nm, y, agg, marg, msum, Bl, W, D,
                                                 F, T, thr, acts, mode, da, db, stage_w);
  return cudaGetLastError();
}

int g_force = -1;  // gnn_bnT_backward_force_plan

using BnTBwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const uint8_t*, const uint8_t*, const float*, const float*,
                          const float*, const float*, const float*, const float*, const float*,
                          float*, float*, float*, float*, int, int, int, int, int,
                          unsigned long long, int, float, float, BnTBwdPlan);

template <int MAXF>
BnTBwdFn bwd_variant(const BnTBwdPlan& p) {
  return p.st ? bnT_bwd_kernel<MAXF, 256, true> : bnT_bwd_kernel<MAXF, 128, false>;
}

// K17's kernel and plan for a shape: the first plan of kBnTBwdPlans that
// fits a CTA, or plan g_force (>= 0) if it fits; nullptr (bytes: the last
// plan's) if none.
BnTBwdFn pick_bwd(int W, int D, int F, int T, BnTBwdPlan* p, size_t* bytes, int* index) {
  constexpr int N = sizeof(kBnTBwdPlans) / sizeof(kBnTBwdPlans[0]);
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i < N; ++i) {
    *bytes = bwdT_layout(W, D, F, T, kBnTBwdPlans[i]).bytes;
    if (*bytes <= (size_t)kMaxSmemBytes) {
      *p = kBnTBwdPlans[i];
      *index = i;
      break;
    }
    if (g_force >= 0) break;
  }
  if (*index < 0) return nullptr;
  switch (width_class(D)) {
    case 16:
      return bwd_variant<16>(*p);
    case 32:
      return bwd_variant<32>(*p);
    case 64:
      return bwd_variant<64>(*p);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// adj_loop [Bl, W, W], adj_dep [R - Bl, W, W] (null when Bl == R); y1, y2,
// rT (nullable) [R, W, D]; aff [2, 2, T, D]; types uint8 [R, W]; keep uint8
// [R, W, 2D + F] (null when mode == 0); feats [R, W, F]; w_stk
// [T * D, 2D + F + 1]; nm [R, W]; acts: type t's activation code at bits
// 2t, 2t + 1 -> y, agg [R, W, D], marg [R, W], msum [R, T, D]. Returns a
// cudaError_t code.
int gnn_bnT_forward(const float* adj_loop, const float* adj_dep, const float* y1,
                    const float* y2, const float* aff, const uint8_t* types, const uint8_t* keep,
                    const float* rT, const float* feats, const float* w_stk, const float* nm,
                    float* y, float* agg, float* marg, float* msum, int R, int Bl, int W, int D,
                    int F, int T, float thr, unsigned long long acts, int mode, float da,
                    float db, void* stream) {
  if (!shape_ok(R, Bl, W, D, F, T)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch_fwd<16>(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, y,
                            agg, marg, msum, R, Bl, W, D, F, T, thr, acts, mode, da, db, st);
    case 32:
      return launch_fwd<32>(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, y,
                            agg, marg, msum, R, Bl, W, D, F, T, thr, acts, mode, da, db, st);
    default:
      return launch_fwd<64>(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, y,
                            agg, marg, msum, R, Bl, W, D, F, T, thr, acts, mode, da, db, st);
  }
}

// As gnn_bnT_forward, plus y_prev, y_k, agg, ds_in, gsel [R, W, D]; bnv
// [T, 9, D]; flag a device float (0 or 1) -> ds, dagg [R, W, D], dw
// [R, T * D, 2D + F + 1], red [R, T, 2, D]. Returns a cudaError_t code.
int gnn_bnT_backward(const float* adj_loop, const float* adj_dep, const float* y_prev,
                     const float* y_k, const float* agg, const uint8_t* types,
                     const uint8_t* keep, const float* feats, const float* w_stk,
                     const float* ds_in, const float* gsel, const float* bnv, const float* flag,
                     const float* nm, float* ds, float* dw, float* dagg, float* red, int R,
                     int Bl, int W, int D, int F, int T, unsigned long long acts, int mode,
                     float da, float db, void* stream) {
  if (!shape_ok(R, Bl, W, D, F, T)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  BnTBwdPlan p;
  size_t bytes;
  int index;
  const BnTBwdFn fn = pick_bwd(W, D, F, T, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk, ds_in, gsel, bnv, flag, nm,
      ds, dw, dagg, red, Bl, W, D, F, T, acts, mode, da, db, p);
  return cudaGetLastError();
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bnT_backward launches for
// this shape. Returns a cudaError_t code.
int gnn_bnT_backward_info(int W, int D, int F, int T, int* out) {
  BnTBwdPlan p;
  size_t bytes;
  int index;
  const BnTBwdFn fn = pick_bwd(W, D, F, T, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` of kBnTBwdPlans from now on, where it fits (a launch
// at a shape it does not fit fails), or the first plan that fits again
// (index -1): for timing one plan against another.
void gnn_bnT_backward_force_plan(int index) { g_force = index; }

}  // extern "C"
