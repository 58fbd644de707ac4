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
// Design, as K1/K2: one CTA per block row, one thread per node (blockDim ==
// W), the block adjacency staged in shared memory at row stride W + 1; sums
// over nodes leave as per-block partials that the caller adds up in order
// (no float atomics: results repeat bit for bit). The per-type coefficient
// rows, the node types and, when they still fit the 227 KB a CTA may use,
// the stacked weights are staged in shared memory; otherwise each thread
// reads its type's weight rows through the L1/L2 caches. In a warp, nodes
// of different types read different weight rows: in shared memory that is a
// bank conflict, not a divergence of control, since every thread runs the
// same loop. The per-type sums (moments, dw, red) run over each type's nodes
// only: the block's nodes are counting-sorted by type once, so they cost
// K1/K2's node loops whatever T is.
//
// Bound: as K1/K2, a launch reads every block's adjacency once (64 KiB at
// W = 128), which dominates the bytes moved; the types add W bytes a block
// and do not grow with T. The least time is set by bytes; this first
// version stages synchronously and contracts the adjacency densely, so its
// time is set by shared-memory traffic and FMAs, as K1/K2's.

#include "common.cuh"

namespace {

using namespace gnn;

// Float offsets of the shared-memory buffers; w last, so the layout without
// staged weights is a prefix.
struct Layout {
  int adj;    // [W][W + 1]  adjT[src][dst]
  int x;      // [W][XP]     x3 rows [s | agg | feats], XP = (2D + F) | 1
  int rows;   // [W][DP]     staging of [W, D] row blocks, DP = D | 1
  int rows2;  // [W][DP]     a second row buffer
  int vec;    // K16: aff [2][2][T][D]; K17: bnv [T][9][D]
  int nm;     // [W]         node mask
  int ty;     // [W]         node types (int)
  int ord;    // [W]         the block's nodes by type, ascending within a type
  int tst;    // [T + 1]     type t's nodes are ord[tst[t] .. tst[t + 1])
  int keep;   // W * (2D + F) bytes of keep bits
  int w;      // [T * D][C]  w_stk, when staged
  int total;
};

__host__ __device__ Layout layout(int W, int D, int F, int T, int vec_rows, bool stage_w) {
  const int C = 2 * D + F + 1;
  Layout l;
  int o = 0;
  l.adj = o;
  o += W * (W + 1);
  l.x = o;
  o += W * ((C - 1) | 1);
  l.rows = o;
  o += W * (D | 1);
  l.rows2 = o;
  o += W * (D | 1);
  l.vec = o;
  o += vec_rows * T * D;
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

// Operands common to both kernels, staged once per CTA: adjacency, (w_stk),
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
  const Layout L = layout(W, D, F, T, 4, stage_w);
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

// K17: one reverse typed BN-training iteration over every block row.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
bnT_bwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
               const float* __restrict__ y_prev, const float* __restrict__ y_k,
               const float* __restrict__ agg, const uint8_t* __restrict__ types,
               const uint8_t* __restrict__ keep, const float* __restrict__ feats,
               const float* __restrict__ w_stk, const float* __restrict__ ds_in,
               const float* __restrict__ gsel, const float* __restrict__ bnv,
               const float* __restrict__ flag, const float* __restrict__ nm,
               float* __restrict__ ds, float* __restrict__ dw, float* __restrict__ dagg,
               float* __restrict__ red, int Bl, int W, int D, int F, int T,
               unsigned long long acts, int mode, float da, float db, int stage_w) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const Layout L = layout(W, D, F, T, 9, stage_w);
  const int C = 2 * D + F + 1, XP = (C - 1) | 1, DP = D | 1;
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = sm + L.adj;
  float* xs = sm + L.x;
  float* xrow = xs + t * XP;
  float* rows = sm + L.rows;
  float* rows2 = sm + L.rows2;
  const float* vec = sm + L.vec;  // bnv [T][9][D], rows ops/bn.py::BNV_ROWS
  const float* nms = sm + L.nm;
  const int* tys = reinterpret_cast<const int*>(sm + L.ty);
  int* ord = reinterpret_cast<int*>(sm + L.ord);
  int* tst = reinterpret_cast<int*>(sm + L.tst);
  const uint8_t* krow = reinterpret_cast<const uint8_t*>(sm + L.keep) + t * (C - 1);

  const float* wbase = stage_typed(sm, L, adj_loop, adj_dep, Bl, w_stk, stage_w, bnv, 9 * T * D,
                                   nm, types, keep, feats, W, D, F, T, mode);
  stage_in(agg + row0 * D, W, D, xs, XP, D);
  stage_in(y_prev + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  order_by_type(tys, W, T, ord, tst);
  const int ty = tys[t];
  const float* v = vec + ty * 9 * D;
  const float* w = wbase + (size_t)ty * D * C;
  // recompute the forward's dropped x3 row: s_prev, agg, feats
  for (int d = 0; d < D; ++d) xrow[d] = __fadd_rn(__fmul_rn(rows[t * DP + d], v[d]), v[D + d]);
  drop_row(xrow, krow, C - 1, mode, da, db);

  // gy from the state cotangent and the node's type's BatchNorm coefficients
  float g[MAXF];
  __syncthreads();
  stage_in(ds_in + row0 * D, W, D, rows, DP, 0);
  stage_in(gsel + row0 * D, W, D, rows2, DP, 0);
  __syncthreads();
  const float f = *flag;
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    g[d] = d < D ? rows[t * DP + d] + f * rows2[t * DP + d] : 0.0f;
  __syncthreads();
  stage_in(y_k + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  const float nmv = nms[t];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      const float xk = (rows[t * DP + d] - v[2 * D + d]) * v[3 * D + d];
      g[d] = v[4 * D + d] * g[d] - nmv * (v[5 * D + d] + xk * v[6 * D + d]);
    }
  }
  {
    float h[MAXF];
    dense_aug<MAXF>(w, xrow, D, C, h);
    const int act = act_of(acts, ty);
#pragma unroll
    for (int j = 0; j < MAXF; ++j) g[j] *= act_grad(act, h[j]);  // g is dh from here
  }
#pragma unroll
  for (int j = 0; j < MAXF; ++j)
    if (j < D) rows2[t * DP + j] = g[j];
  __syncthreads();

  // this block's dw[t' * D + j][c] = sum over type-t' nodes n of dh[n][j] * [x3 row n; 1][c]
  for (int o = t; o < T * D * C; o += blockDim.x) {
    const int jr = o / C, c = o % C, tt = jr / D, j = jr % D;
    float s = 0.0f;
    if (c < C - 1) {
      for (int k = tst[tt]; k < tst[tt + 1]; ++k) {
        const int n = ord[k];
        s = fmaf(rows2[n * DP + j], xs[n * XP + c], s);
      }
    } else {
      for (int k = tst[tt]; k < tst[tt + 1]; ++k) s += rows2[ord[k] * DP + j];
    }
    dw[(size_t)r * T * D * C + o] = s;
  }

  // dx = dh @ [Ws | Wa] of the node's type, through the dropout's derivative
  float dxs[MAXF], dxa[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) dxs[d] = dxa[d] = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXF; ++j) {
    if (j < D) {
#pragma unroll
      for (int d = 0; d < MAXF; ++d) {
        if (d < D) {
          dxs[d] = fmaf(g[j], w[j * C + d], dxs[d]);
          dxa[d] = fmaf(g[j], w[j * C + D + d], dxa[d]);
        }
      }
    }
  }
  if (mode != kNoDrop) {
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      if (d < D) {
        dxs[d] *= krow[d] ? da : 0.0f;
        dxa[d] *= krow[D + d] ? da : 0.0f;
      }
    }
  }
  __syncthreads();  // the dw sums are done with rows2
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    if (d < D) rows2[t * DP + d] = dxa[d];
  __syncthreads();
  stage_out(dagg + row0 * D, W, D, rows2, DP);

  // ds[t] = dxs[t] + sum_dst adjT[t][dst] * dagg[dst], reading row t
#pragma unroll
  for (int d = 0; d < MAXF; ++d) dxa[d] = 0.0f;
  for (int dst = 0; dst < W; ++dst) {
    const float a = adj[t * (W + 1) + dst];
    const float* grow = rows2 + dst * DP;
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) dxa[d] = fmaf(a, grow[d], dxa[d]);
  }
#pragma unroll
  for (int d = 0; d < MAXF; ++d)
    if (d < D) rows[t * DP + d] = dxs[d] + dxa[d];
  __syncthreads();
  stage_out(ds + row0 * D, W, D, rows, DP);
  __syncthreads();  // dagg is out of rows2
  stage_in(y_prev + row0 * D, W, D, rows2, DP, 0);
  __syncthreads();
  // the next reverse step's per-type reduction partials against x_hat_prev
  for (int o = t; o < T * D; o += blockDim.x) {
    const int tt = o / D, d = o % D;
    const float* vt = vec + tt * 9 * D;
    float s0 = 0.0f, s1 = 0.0f;
    for (int k = tst[tt]; k < tst[tt + 1]; ++k) {
      const int n = ord[k];
      const float dsv = rows[n * DP + d];
      s0 += dsv;
      s1 = fmaf(dsv, (rows2[n * DP + d] - vt[7 * D + d]) * vt[8 * D + d], s1);
    }
    red[((size_t)r * T + tt) * 2 * D + d] = s0;
    red[((size_t)r * T + tt) * 2 * D + D + d] = s1;
  }
}

bool shape_ok(int R, int Bl, int W, int D, int F, int T) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && T >= 1 && T <= 32 && width_class(D) != 0;
}

// Shared memory of a launch: with the stacked weights when they fit a CTA,
// else without (ops/typed.py::typed_smem_bytes mirrors it).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int W, int D, int F, int T, int vec_rows, size_t* bytes,
                    int* stage_w) {
  *bytes = sizeof(float) * (size_t)layout(W, D, F, T, vec_rows, true).total;
  *stage_w = *bytes <= (size_t)kMaxSmemBytes;
  if (!*stage_w) *bytes = sizeof(float) * (size_t)layout(W, D, F, T, vec_rows, false).total;
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
  cudaError_t err = prepare(bnT_fwd_kernel<MAXF>, W, D, F, T, 4, &bytes, &stage_w);
  if (err != cudaSuccess) return err;
  bnT_fwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y1, y2, aff, types, keep, rT,
                                                 feats, w_stk, nm, y, agg, marg, msum, Bl, W, D,
                                                 F, T, thr, acts, mode, da, db, stage_w);
  return cudaGetLastError();
}

template <int MAXF>
cudaError_t launch_bwd(const float* adj_loop, const float* adj_dep, const float* y_prev,
                       const float* y_k, const float* agg, const uint8_t* types,
                       const uint8_t* keep, const float* feats, const float* w_stk,
                       const float* ds_in, const float* gsel, const float* bnv,
                       const float* flag, const float* nm, float* ds, float* dw, float* dagg,
                       float* red, int R, int Bl, int W, int D, int F, int T,
                       unsigned long long acts, int mode, float da, float db,
                       cudaStream_t stream) {
  size_t bytes;
  int stage_w;
  cudaError_t err = prepare(bnT_bwd_kernel<MAXF>, W, D, F, T, 9, &bytes, &stage_w);
  if (err != cudaSuccess) return err;
  bnT_bwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y_prev, y_k, agg, types, keep,
                                                 feats, w_stk, ds_in, gsel, bnv, flag, nm, ds, dw,
                                                 dagg, red, Bl, W, D, F, T, acts, mode, da, db,
                                                 stage_w);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch_bwd<16>(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk,
                            ds_in, gsel, bnv, flag, nm, ds, dw, dagg, red, R, Bl, W, D, F, T,
                            acts, mode, da, db, st);
    case 32:
      return launch_bwd<32>(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk,
                            ds_in, gsel, bnv, flag, nm, ds, dw, dagg, red, R, Bl, W, D, F, T,
                            acts, mode, da, db, st);
    default:
      return launch_bwd<64>(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk,
                            ds_in, gsel, bnv, flag, nm, ds, dw, dagg, red, R, Bl, W, D, F, T,
                            acts, mode, da, db, st);
  }
}

}  // extern "C"
