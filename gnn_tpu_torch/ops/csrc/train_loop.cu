// Dropout-training propagation kernels of the GNN fixed-point loop for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16), for a state
// net of one dense layer with input dropout and no BatchNorm.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K6 _train_kernel_T        (launched by _train_fwd_impl)      -> gnn_train_step
//   K7 _loop_train_kernel_T   (launched by _loop_train_impl)     -> gnn_train_loop
// K7's reverse, K8, is in train_loop_bwd.cu.
//
// One training iteration on one W-node block, node-major rows; the arc-label
// slice of the dense input is dropped and folded into fT outside:
//   agg = adjT^T @ s (+ rT)             agg[dst] = sum_src adjT[src, dst] * s[src]
//   x2  = [drop(s, ms) | drop(agg, ma)] the dense input's state and agg slices
//   s'  = act(w_cat @ x2 + fT)          w_cat = [Ws | Wa], [H, 2D]
// The dropout sits between the aggregation and Wa, so Wa cannot be moved
// through the aggregation as in K3: the aggregation is D wide.
// K7 runs all K iterations of a residual-free block on its adjacency staged
// once, with a fresh fT[k] and masks per iteration, and writes the state after
// every iteration (traj), the pre-update movement flags and the pre-dropout
// aggregations (saved for K8).
// K6 runs one iteration of a residual-coupled block: the state slice arrives
// dropped (sd), the raw residual aggregation rT is added before the aggregated
// slice's dropout; its backward is plain PyTorch, as gnn_tpu's is XLA.
//
// Design: one CTA per block, one thread per node (blockDim == W). The
// adjacency is staged in shared memory with row stride W + 1, so reading a
// column (a thread per destination) is free of bank conflicts. A thread's x2
// row lives in shared memory (odd stride) so the dense layer loops over it at
// run time; its accumulators are registers sized by a template (16, 32 or 64
// wide). Each thread reads its own keep bytes straight from device memory.
//
// Bound: K7 reads each block's adjacency (64 KiB at W = 128) once for all K
// iterations and streams K per-iteration rows (fT, masks, traj, agg); the
// dense layer costs 4*D*D flops per node and iteration and the arcs present
// 2*D each, so the least time is set by bytes. This first version stages
// synchronously and contracts the adjacency densely (2*D*W*W flops per block
// and iteration), as K3 does: its time is set by shared-memory traffic and
// FMAs, not bytes.

#include "common.cuh"

namespace {

using namespace gnn;

// This thread's h += w @ xrow over n inputs (w rows of stride ldw).
template <int MAXF>
__device__ void dense_acc(const float* w, int ldw, const float* xrow, int n, int H,
                          float (&h)[MAXF]) {
  for (int c = 0; c < n; ++c) {
    const float x = xrow[c];
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < H) h[j] = fmaf(w[j * ldw + c], x, h[j]);
  }
}

// K7: all K dropout-training iterations of residual-free blocks (H == D).
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
train_loop_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                  const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                  const float* __restrict__ fT, const float* __restrict__ w_cat,
                  const float* __restrict__ nm, float* __restrict__ traj,
                  float* __restrict__ marg, float* __restrict__ agg_out, int B, int W, int D,
                  int K, float thr, int act, int mode, float da, float db) {
  extern __shared__ float4 smem_raw[];
  const int DP = D | 1, C2 = 2 * D, XP = C2 | 1;
  float* adj = reinterpret_cast<float*>(smem_raw);  // [W][W + 1]
  float* S = adj + W * (W + 1);                     // [W][DP] the block's state
  float* rows = S + W * DP;                         // [W][DP] staging
  float* X = rows + W * DP;                         // [W][XP] x2 rows
  float* w = X + W * XP;                            // [D][2D]
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  float* xrow = X + t * XP;

  stage_adj(adjT + row0 * W, W, adj);
  for (int i = t; i < D * C2; i += blockDim.x) w[i] = w_cat[i];
  stage_in(s0 + row0 * D, W, D, S, DP, 0);
  __syncthreads();
  float s[MAXF], s_old[MAXF], a[MAXF];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    s[d] = d < D ? S[t * DP + d] : 0.0f;
    s_old[d] = 1.0f;
  }
  const float nmv = nm[row0 + t];

  for (int k = 0; k < K; ++k) {
    const size_t kb = (size_t)k * B + b;  // block b of iteration k in [K, B, ...]
    // movement test before update k: ||s - s_old|| > thr * ||s_old||
    float dist2 = 0.0f, norm2 = 0.0f;
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      if (d < D) {
        const float diff = s[d] - s_old[d];
        dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
        norm2 = __fadd_rn(norm2, __fmul_rn(s_old[d], s_old[d]));
      }
    }
    marg[kb * W + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nmv : 0.0f;

    aggregate_col<MAXF>(adj, W, S, DP, D, a);
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) rows[t * DP + d] = a[d];
    __syncthreads();
    stage_out(agg_out + kb * W * D, W, D, rows, DP);
    __syncthreads();
    stage_in(fT + kb * W * D, W, D, rows, DP, 0);
    __syncthreads();

    // x2 = [drop(s, ms[k]) | drop(agg, ma[k])], h = w_cat @ x2 + fT[k]
    const uint8_t* ks = mode != kNoDrop ? ms + (kb * W + t) * D : nullptr;
    const uint8_t* ka = mode != kNoDrop ? ma + (kb * W + t) * D : nullptr;
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      if (d < D) {
        xrow[d] = drop(mode, da, db, s[d], ks != nullptr && ks[d] != 0);
        xrow[D + d] = drop(mode, da, db, a[d], ka != nullptr && ka[d] != 0);
      }
    }
    float h[MAXF];
#pragma unroll
    for (int j = 0; j < MAXF; ++j) h[j] = 0.0f;
    dense_acc<MAXF>(w, C2, xrow, C2, D, h);
#pragma unroll
    for (int j = 0; j < MAXF; ++j) {
      s_old[j] = s[j];
      s[j] = j < D ? activate(act, h[j] + rows[t * DP + j]) : 0.0f;
      if (j < D) S[t * DP + j] = s[j];  // every thread is past the aggregation
    }
    __syncthreads();
    stage_out(traj + kb * W * D, W, D, S, DP);
  }
}

// K6: one dropout-training iteration of residual-coupled blocks; rT, m nullable.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
train_step_kernel(const float* __restrict__ adjT, const float* __restrict__ s,
                  const float* __restrict__ sd, const uint8_t* __restrict__ m,
                  const float* __restrict__ rT, const float* __restrict__ fT,
                  const float* __restrict__ w_cat, float* __restrict__ y,
                  float* __restrict__ agg_out, int W, int D, int H, int act, int mode, float da,
                  float db) {
  extern __shared__ float4 smem_raw[];
  const int C2 = 2 * D, XP = C2 | 1, FP = (D > H ? D : H) | 1;
  float* adj = reinterpret_cast<float*>(smem_raw);  // [W][W + 1]
  float* S = adj + W * (W + 1);                     // [W][FP] s, then staging
  float* X = S + W * FP;                            // [W][XP] x2 rows
  float* w = X + W * XP;                            // [H][2D]
  const int t = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * W;
  float* xrow = X + t * XP;

  stage_adj(adjT + row0 * W, W, adj);
  for (int i = t; i < H * C2; i += blockDim.x) w[i] = w_cat[i];
  stage_in(s + row0 * D, W, D, S, FP, 0);
  stage_in(sd + row0 * D, W, D, X, XP, 0);
  if (rT != nullptr) stage_in(rT + row0 * D, W, D, X, XP, D);
  __syncthreads();
  float a[MAXF];
  aggregate_col<MAXF>(adj, W, S, FP, D, a);
  if (rT != nullptr) {
#pragma unroll
    for (int d = 0; d < MAXF; ++d)
      if (d < D) a[d] += xrow[D + d];
  }
  __syncthreads();  // every thread is done with S
  const uint8_t* km = mode != kNoDrop ? m + (row0 + t) * D : nullptr;
#pragma unroll
  for (int d = 0; d < MAXF; ++d) {
    if (d < D) {
      S[t * FP + d] = a[d];
      xrow[D + d] = drop(mode, da, db, a[d], km != nullptr && km[d] != 0);
    }
  }
  __syncthreads();
  stage_out(agg_out + row0 * D, W, D, S, FP);
  __syncthreads();
  stage_in(fT + row0 * H, W, H, S, FP, 0);
  __syncthreads();
  float h[MAXF];
#pragma unroll
  for (int j = 0; j < MAXF; ++j) h[j] = 0.0f;
  dense_acc<MAXF>(w, C2, xrow, C2, H, h);
#pragma unroll
  for (int j = 0; j < MAXF; ++j)
    if (j < H) h[j] = activate(act, h[j] + S[t * FP + j]);
  __syncthreads();  // every thread has read its fT row
#pragma unroll
  for (int j = 0; j < MAXF; ++j)
    if (j < H) S[t * FP + j] = h[j];
  __syncthreads();
  stage_out(y + row0 * H, W, H, S, FP);
}

size_t loop_smem(int W, int D) {
  return sizeof(float) * ((size_t)W * (W + 1) + 2 * (size_t)W * (D | 1) +
                          (size_t)W * ((2 * D) | 1) + 2 * (size_t)D * D);
}

size_t step_smem(int W, int D, int H) {
  return sizeof(float) * ((size_t)W * (W + 1) + (size_t)W * ((D > H ? D : H) | 1) +
                          (size_t)W * ((2 * D) | 1) + 2 * (size_t)H * D);
}

template <int MAXF>
cudaError_t launch_loop(const float* adjT, const float* s0, const uint8_t* ms,
                        const uint8_t* ma, const float* fT, const float* w_cat, const float* nm,
                        float* traj, float* marg, float* agg, int B, int W, int D, int K,
                        float thr, int act, int mode, float da, float db, cudaStream_t stream) {
  const size_t bytes = loop_smem(W, D);
  cudaError_t err = set_smem(train_loop_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  train_loop_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s0, ms, ma, fT, w_cat, nm, traj, marg,
                                                    agg, B, W, D, K, thr, act, mode, da, db);
  return cudaGetLastError();
}

template <int MAXF>
cudaError_t launch_step(const float* adjT, const float* s, const float* sd, const uint8_t* m,
                        const float* rT, const float* fT, const float* w_cat, float* y,
                        float* agg, int B, int W, int D, int H, int act, int mode, float da,
                        float db, cudaStream_t stream) {
  const size_t bytes = step_smem(W, D, H);
  cudaError_t err = set_smem(train_step_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  train_step_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s, sd, m, rT, fT, w_cat, y, agg, W, D,
                                                    H, act, mode, da, db);
  return cudaGetLastError();
}

bool drop_ok(int mode, const uint8_t* a, const uint8_t* b) {
  return mode == kNoDrop || (a != nullptr && b != nullptr);
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], ms/ma uint8 [K, B, W, D] (null when mode == 0),
// fT [K, B, W, D], w_cat [D, 2D], nm [B, W] -> traj, agg [K, B, W, D],
// marg [K, B, W]. Returns a cudaError_t code.
int gnn_train_loop(const float* adjT, const float* s0, const uint8_t* ms, const uint8_t* ma,
                   const float* fT, const float* w_cat, const float* nm, float* traj,
                   float* marg, float* agg, int B, int W, int D, int K, float thr, int act,
                   int mode, float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || !drop_ok(mode, ms, ma)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch_loop<16>(adjT, s0, ms, ma, fT, w_cat, nm, traj, marg, agg, B, W, D, K, thr,
                             act, mode, da, db, st);
    case 32:
      return launch_loop<32>(adjT, s0, ms, ma, fT, w_cat, nm, traj, marg, agg, B, W, D, K, thr,
                             act, mode, da, db, st);
    case 64:
      return launch_loop<64>(adjT, s0, ms, ma, fT, w_cat, nm, traj, marg, agg, B, W, D, K, thr,
                             act, mode, da, db, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// adjT [B, W, W], s/sd [B, W, D], m uint8 [B, W, D] (null when mode == 0),
// rT [B, W, D] (nullable), fT [B, W, H], w_cat [H, 2D] -> y [B, W, H],
// agg [B, W, D]. Returns a cudaError_t code.
int gnn_train_step(const float* adjT, const float* s, const float* sd, const uint8_t* m,
                   const float* rT, const float* fT, const float* w_cat, float* y, float* agg,
                   int B, int W, int D, int H, int act, int mode, float da, float db,
                   void* stream) {
  if (!block_ok(B, W) || D <= 0 || H <= 0 || !drop_ok(mode, m, m)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > H ? D : H)) {
    case 16:
      return launch_step<16>(adjT, s, sd, m, rT, fT, w_cat, y, agg, B, W, D, H, act, mode, da, db,
                             st);
    case 32:
      return launch_step<32>(adjT, s, sd, m, rT, fT, w_cat, y, agg, B, W, D, H, act, mode, da, db,
                             st);
    case 64:
      return launch_step<64>(adjT, s, sd, m, rT, fT, w_cat, y, agg, B, W, D, H, act, mode, da, db,
                             st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
