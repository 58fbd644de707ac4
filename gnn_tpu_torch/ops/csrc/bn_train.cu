// BatchNorm-training propagation kernels of the GNN fixed-point loop for
// Hopper (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K1 _bn_fwd_kernel (launched by _bn_fwd_call) -> gnn_bn_forward
//   K2 _bn_bwd_kernel (launched by _bn_bwd_call) -> gnn_bn_backward
//
// A state net with a trailing BatchNorm couples every block each iteration
// through the batch moments, so one launch runs one iteration over every
// block row, and [D]-sized glue (ops/bn.py) runs between launches.
//
// K1, one iteration on one W-node block, node-major rows (x3 = the dense
// input [s | agg | feats], C = 2D + F + 1 columns of w_aug = [Ws|Wa|Wf|b]):
//   s     = y1 * scale1 + shift1,  s_old = y2 * scale2 + shift2
//   marg  = nm if ||s - s_old|| > thr * ||s_old|| else 0
//   agg   = adjT^T @ s (+ rT)                  written before the dropout
//   y     = act(w_aug @ [drop(x3); 1])         the pre-BN activation
//   msum  = sum over the block's nodes of y * nm
// K2, the reverse of K1 with the BatchNorm backward folded in from the [9, D]
// coefficient rows bnv (ops/bn.py::BNV_ROWS):
//   gy    = gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2)
//   dh    = gy * act'(h),  dw = dh^T @ [drop(x3); 1]   (per-block partial)
//   dagg  = (dh @ Wa) * dmask,  ds = (dh @ Ws) * dmask + adjT @ dagg
//   red   = (sum ds, sum ds * x_hat_prev)              (per-block partial)
// Sums over nodes leave as per-block partials that the caller adds up in
// order: no float atomics, so a result does not vary between runs.
//
// Design: one CTA per block, one thread per node (blockDim == W). The block
// adjacency is staged in shared memory with a padded row stride W + 1, so K1
// reading a column (a thread per destination) and K2 reading a row (a thread
// per source) are both free of bank conflicts. Row blocks move between
// device memory and shared memory as contiguous copies; x3 rows keep an odd
// stride so a thread reading its own row does not conflict either. A thread
// keeps its node's accumulators in registers sized by a template (16, 32 or
// 64 wide, unrolled with width guards).
//
// Bound: a launch reads every block's adjacency (W*W*4 bytes, 64 KiB at
// W = 128) once, which dominates the bytes moved; the arcs present need
// 2*D flops each per direction, and the dense layer 2*D*C per node, so the
// least time is set by bytes. This first version stages the adjacency
// synchronously and contracts it densely (2*D*W*W flops per block), as K3
// does: its time is set by shared-memory traffic and FMAs, not bytes.

#include "common.cuh"

namespace {

using namespace gnn;

// Float offsets of the shared-memory buffers; the same for K1 and K2.
struct Layout {
  int adj;    // [W][W + 1]  adjT[src][dst]
  int x;      // [W][XP]     x3 rows [s | agg | feats], XP = (2D + F) | 1
  int rows;   // [W][DP]     staging of [W, D] row blocks, DP = D | 1
  int rows2;  // [W][DP]     a second row buffer
  int w;      // [D][C]      w_aug
  int vec;    // [9][D]      K1: the two affines; K2: bnv
  int nm;     // [W]         node mask
  int keep;   // W * (2D + F) bytes of keep bits
  int total;
};

__host__ __device__ Layout layout(int W, int D, int F) {
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
  l.w = o;
  o += D * C;
  l.vec = o;
  o += 9 * D;
  l.nm = o;
  o += W;
  l.keep = o;
  o += (W * (C - 1) + 3) / 4;
  l.total = o;
  return l;
}

// Operands common to both kernels, staged once per CTA: adjacency, w_aug,
// the [rows, D] coefficient vectors, node mask, keep bits and the feats
// columns of x3.
__device__ void stage_common(float* sm, const Layout& L, const float* adj_loop,
                             const float* adj_dep, int Bl, const float* __restrict__ w_aug,
                             const float* __restrict__ vec, int vec_rows,
                             const float* __restrict__ nm, const uint8_t* __restrict__ keep,
                             const float* __restrict__ feats, int W, int D, int F, int mode) {
  const int r = blockIdx.x;
  const size_t row0 = (size_t)r * W;
  const int C = 2 * D + F + 1;
  stage_adj(block_adj(adj_loop, adj_dep, Bl, W), W, sm + L.adj);
  for (int i = threadIdx.x; i < D * C; i += blockDim.x) sm[L.w + i] = w_aug[i];
  for (int i = threadIdx.x; i < vec_rows * D; i += blockDim.x) sm[L.vec + i] = vec[i];
  sm[L.nm + threadIdx.x] = nm[row0 + threadIdx.x];
  if (mode != kNoDrop) {
    uint8_t* kp = reinterpret_cast<uint8_t*>(sm + L.keep);
    const uint8_t* kg = keep + row0 * (C - 1);
    for (int i = threadIdx.x; i < W * (C - 1); i += blockDim.x) kp[i] = kg[i];
  }
  stage_in(feats + row0 * F, W, F, sm + L.x, (C - 1) | 1, 2 * D);
}

// K1: one BN-training iteration over every block row (row r < Bl reads
// adj_loop[r], the rest adj_dep[r - Bl]).
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
bn_fwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
              const float* __restrict__ y1, const float* __restrict__ y2,
              const float* __restrict__ aff, const uint8_t* __restrict__ keep,
              const float* __restrict__ rT, const float* __restrict__ feats,
              const float* __restrict__ w_aug, const float* __restrict__ nm,
              float* __restrict__ y, float* __restrict__ agg, float* __restrict__ marg,
              float* __restrict__ msum, int Bl, int W, int D, int F, float thr, int act,
              int mode, float da, float db) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const Layout L = layout(W, D, F);
  const int C = 2 * D + F + 1, XP = (C - 1) | 1, DP = D | 1;
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = sm + L.adj;
  float* xs = sm + L.x;
  float* xrow = xs + t * XP;
  float* rows = sm + L.rows;
  const float* w = sm + L.w;
  const float* vec = sm + L.vec;  // [scale1; shift1; scale2; shift2]
  const float* nms = sm + L.nm;
  const uint8_t* krow = reinterpret_cast<const uint8_t*>(sm + L.keep) + t * (C - 1);

  stage_common(sm, L, adj_loop, adj_dep, Bl, w_aug, aff, 4, nm, keep, feats, W, D, F, mode);
  stage_in(y1 + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  // s -> x3 columns [0, D); rounded as the plain version's multiply, then add
  for (int d = 0; d < D; ++d) xrow[d] = __fadd_rn(__fmul_rn(rows[t * DP + d], vec[d]), vec[D + d]);
  __syncthreads();
  stage_in(y2 + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  float dist2 = 0.0f, norm2 = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float so = __fadd_rn(__fmul_rn(rows[t * DP + d], vec[2 * D + d]), vec[3 * D + d]);
    const float diff = __fsub_rn(xrow[d], so);
    dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
    norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
  }
  marg[row0 + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[t] : 0.0f;
  __syncthreads();
  if (rT != nullptr) stage_in(rT + row0 * D, W, D, rows, DP, 0);
  __syncthreads();

  // agg[t] = sum_src adjT[src][t] * s[src], reading column t of the adjacency
  float acc[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) acc[d] = 0.0f;
  for (int src = 0; src < W; ++src) {
    const float a = adj[src * (W + 1) + t];
    const float* srow = xs + src * XP;
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) acc[d] = fmaf(a, srow[d], acc[d]);
  }
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
  dense_aug<MAXF>(w, xrow, D, C, h);
  __syncthreads();  // agg is out of rows
#pragma unroll
  for (int j = 0; j < MAXF; ++j)
    if (j < D) rows[t * DP + j] = activate(act, h[j]);
  __syncthreads();
  stage_out(y + row0 * D, W, D, rows, DP);
  for (int d = t; d < D; d += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < W; ++n) s = fmaf(rows[n * DP + d], nms[n], s);
    msum[(size_t)r * D + d] = s;
  }
}

// K2: one reverse BN-training iteration over every block row.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
bn_bwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
              const float* __restrict__ y_prev, const float* __restrict__ y_k,
              const float* __restrict__ agg, const uint8_t* __restrict__ keep,
              const float* __restrict__ feats, const float* __restrict__ w_aug,
              const float* __restrict__ ds_in, const float* __restrict__ gsel,
              const float* __restrict__ bnv, const float* __restrict__ flag,
              const float* __restrict__ nm, float* __restrict__ ds, float* __restrict__ dw,
              float* __restrict__ dagg, float* __restrict__ red, int Bl, int W, int D, int F,
              int act, int mode, float da, float db) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const Layout L = layout(W, D, F);
  const int C = 2 * D + F + 1, XP = (C - 1) | 1, DP = D | 1;
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = sm + L.adj;
  float* xs = sm + L.x;
  float* xrow = xs + t * XP;
  float* rows = sm + L.rows;
  float* rows2 = sm + L.rows2;
  const float* w = sm + L.w;
  const float* v = sm + L.vec;  // bnv rows, ops/bn.py::BNV_ROWS
  const float* nms = sm + L.nm;
  const uint8_t* krow = reinterpret_cast<const uint8_t*>(sm + L.keep) + t * (C - 1);

  stage_common(sm, L, adj_loop, adj_dep, Bl, w_aug, bnv, 9, nm, keep, feats, W, D, F, mode);
  stage_in(agg + row0 * D, W, D, xs, XP, D);
  stage_in(y_prev + row0 * D, W, D, rows, DP, 0);
  __syncthreads();
  // recompute the forward's dropped x3 row: s_prev, agg, feats
  for (int d = 0; d < D; ++d) xrow[d] = __fadd_rn(__fmul_rn(rows[t * DP + d], v[d]), v[D + d]);
  drop_row(xrow, krow, C - 1, mode, da, db);

  // gy from the state cotangent and the BatchNorm backward coefficients
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
#pragma unroll
    for (int j = 0; j < MAXF; ++j) g[j] *= act_grad(act, h[j]);  // g is dh from here
  }
#pragma unroll
  for (int j = 0; j < MAXF; ++j)
    if (j < D) rows2[t * DP + j] = g[j];
  __syncthreads();

  // this block's dw[j][c] = sum_n dh[n][j] * [x3 row n; 1][c]
  for (int o = t; o < D * C; o += blockDim.x) {
    const int j = o / C, c = o % C;
    float s = 0.0f;
    if (c < C - 1) {
      for (int n = 0; n < W; ++n) s = fmaf(rows2[n * DP + j], xs[n * XP + c], s);
    } else {
      for (int n = 0; n < W; ++n) s += rows2[n * DP + j];
    }
    dw[(size_t)r * D * C + o] = s;
  }

  // dx = dh @ [Ws | Wa], through the dropout's derivative a * keep
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
  // the next reverse step's reduction partials against x_hat_prev
  for (int d = t; d < D; d += blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int n = 0; n < W; ++n) {
      const float dsv = rows[n * DP + d];
      s0 += dsv;
      s1 = fmaf(dsv, (rows2[n * DP + d] - v[7 * D + d]) * v[8 * D + d], s1);
    }
    red[(size_t)r * 2 * D + d] = s0;
    red[(size_t)r * 2 * D + D + d] = s1;
  }
}

bool shape_ok(int R, int Bl, int W, int D, int F) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0 && width_class(D) != 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int W, int D, int F, size_t* bytes) {
  *bytes = sizeof(float) * (size_t)layout(W, D, F).total;
  return set_smem(kernel, *bytes);
}

template <int MAXF>
cudaError_t launch_fwd(const float* adj_loop, const float* adj_dep, const float* y1,
                       const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                       const float* feats, const float* w_aug, const float* nm, float* y,
                       float* agg, float* marg, float* msum, int R, int Bl, int W, int D, int F,
                       float thr, int act, int mode, float da, float db, cudaStream_t stream) {
  size_t bytes;
  cudaError_t err = prepare(bn_fwd_kernel<MAXF>, W, D, F, &bytes);
  if (err != cudaSuccess) return err;
  bn_fwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats,
                                                w_aug, nm, y, agg, marg, msum, Bl, W, D, F, thr,
                                                act, mode, da, db);
  return cudaGetLastError();
}

template <int MAXF>
cudaError_t launch_bwd(const float* adj_loop, const float* adj_dep, const float* y_prev,
                       const float* y_k, const float* agg, const uint8_t* keep,
                       const float* feats, const float* w_aug, const float* ds_in,
                       const float* gsel, const float* bnv, const float* flag, const float* nm,
                       float* ds, float* dw, float* dagg, float* red, int R, int Bl, int W, int D,
                       int F, int act, int mode, float da, float db, cudaStream_t stream) {
  size_t bytes;
  cudaError_t err = prepare(bn_bwd_kernel<MAXF>, W, D, F, &bytes);
  if (err != cudaSuccess) return err;
  bn_bwd_kernel<MAXF><<<R, W, bytes, stream>>>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats,
                                                w_aug, ds_in, gsel, bnv, flag, nm, ds, dw, dagg,
                                                red, Bl, W, D, F, act, mode, da, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// adj_loop [Bl, W, W], adj_dep [R - Bl, W, W] (null when Bl == R); y1, y2,
// rT (nullable) [R, W, D]; aff [2, 2, D]; keep uint8 [R, W, 2D + F]
// (null when mode == 0); feats [R, W, F]; w_aug [D, 2D + F + 1]; nm [R, W]
// -> y, agg [R, W, D], marg [R, W], msum [R, D]. Returns a cudaError_t code.
int gnn_bn_forward(const float* adj_loop, const float* adj_dep, const float* y1,
                   const float* y2, const float* aff, const uint8_t* keep, const float* rT,
                   const float* feats, const float* w_aug, const float* nm, float* y,
                   float* agg, float* marg, float* msum, int R, int Bl, int W, int D, int F,
                   float thr, int act, int mode, float da, float db, void* stream) {
  if (!shape_ok(R, Bl, W, D, F)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch_fwd<16>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, y, agg,
                            marg, msum, R, Bl, W, D, F, thr, act, mode, da, db, st);
    case 32:
      return launch_fwd<32>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, y, agg,
                            marg, msum, R, Bl, W, D, F, thr, act, mode, da, db, st);
    default:
      return launch_fwd<64>(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, y, agg,
                            marg, msum, R, Bl, W, D, F, thr, act, mode, da, db, st);
  }
}

// As gnn_bn_forward, plus y_prev, y_k, agg, ds_in, gsel [R, W, D]; bnv [9, D];
// flag a device float (0 or 1) -> ds, dagg [R, W, D], dw [R, D, 2D + F + 1],
// red [R, 2, D]. Returns a cudaError_t code.
int gnn_bn_backward(const float* adj_loop, const float* adj_dep, const float* y_prev,
                    const float* y_k, const float* agg, const uint8_t* keep, const float* feats,
                    const float* w_aug, const float* ds_in, const float* gsel, const float* bnv,
                    const float* flag, const float* nm, float* ds, float* dw, float* dagg,
                    float* red, int R, int Bl, int W, int D, int F, int act, int mode, float da,
                    float db, void* stream) {
  if (!shape_ok(R, Bl, W, D, F)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch_bwd<16>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel,
                            bnv, flag, nm, ds, dw, dagg, red, R, Bl, W, D, F, act, mode, da, db,
                            st);
    case 32:
      return launch_bwd<32>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel,
                            bnv, flag, nm, ds, dw, dagg, red, R, Bl, W, D, F, act, mode, da, db,
                            st);
    default:
      return launch_bwd<64>(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel,
                            bnv, flag, nm, ds, dw, dagg, red, R, Bl, W, D, F, act, mode, da, db,
                            st);
  }
}

}  // extern "C"
