// Backward of the eval propagation loop K3 for Hopper (sm_90a), in plain fp32
// on the CUDA cores (no TF32, no bf16): the gradient of a state net without
// dropout and BatchNorm trained through the eval kernels.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K5 _loop_bwd_kernel (launched by _loop_bwd_impl) -> gnn_propagation_loop_bwd
//
// All K reverse iterations of K3 on one W-node block, in K3's algebra (the
// dense layer reassociated through the aggregation, H == D), node-major rows:
//   u   = s_in @ [Ws; Wa]^T,  h = u[:, :H] + adjT^T @ u[:, H:] + fT
//   gy  = g_traj[k] + gs;     with an affine (scale; shift) after the activation:
//         daff += (sum gy * act(h), sum gy),  gy *= scale
//   dh  = gy * act'(h);       dfT += dh (fT is loop-invariant)
//   dua = adjT @ dh           dua[src] = sum_dst adjT[src, dst] * dh[dst]
//   du  = [dh | dua];         dw2 += du^T @ s_in;  gs = du @ [Ws; Wa]
// with s_in = traj[k - 1], or s0 for k = 0.
//
// Design: as K3 and K8 (train_loop.cu), one CTA per block and one thread per
// node; the adjacency is staged once in shared memory with row stride W + 1,
// read by columns for h (a thread per destination) and by rows for dua (a
// thread per source). s_in and du of every node sit in shared memory for the
// dw2 sums; a thread keeps its fT, h, dfT and gs in registers. The dw2 and daff
// partials of a block are accumulated in the outputs by the thread that owns
// each entry, so a result does not vary between runs.
//
// Bound: a launch reads each block's adjacency once for all K reverse steps and
// streams s0, fT, K trajectories and K cotangents, and writes gs and dfT; the
// least time is set by bytes. This first version recomputes the forward's
// dense contraction of the adjacency (2*H*W*W flops per block and step) and
// contracts it densely once more for dua: its time is set by shared-memory
// traffic and FMAs, not bytes.

#include "common.cuh"

namespace {

using namespace gnn;

template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
loop_bwd_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                const float* __restrict__ traj, const float* __restrict__ fT,
                const float* __restrict__ w2, const float* __restrict__ aff,
                const float* __restrict__ g_traj, float* __restrict__ gs_out,
                float* __restrict__ dw2_out, float* __restrict__ dfT_out,
                float* __restrict__ daff_out, int B, int W, int D, int K, int act) {
  extern __shared__ float4 smem_raw[];
  const int H = D, DP = D | 1, UP = (2 * H) | 1;
  float* adj = reinterpret_cast<float*>(smem_raw);  // [W][W + 1]
  float* S = adj + W * (W + 1);                     // [W][DP] s_in rows
  float* U = S + W * DP;                            // [W][UP] staging, ua, du
  float* w = U + W * UP;                            // [2H][D]
  float* sc = w + 2 * H * D;                        // [H] affine scale
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  const bool has_aff = aff != nullptr;
  float* urow = U + t * UP;
  float* dw2 = dw2_out + (size_t)b * 2 * H * D;
  float* daff = has_aff ? daff_out + (size_t)b * 2 * H : nullptr;

  stage_adj(adjT + row0 * W, W, adj);
  for (int i = t; i < 2 * H * D; i += blockDim.x) {
    w[i] = w2[i];
    dw2[i] = 0.0f;  // owned by this thread from here on
  }
  if (has_aff) {
    for (int i = t; i < H; i += blockDim.x) sc[i] = aff[i];
    for (int i = t; i < 2 * H; i += blockDim.x) daff[i] = 0.0f;
  }
  stage_in(fT + row0 * H, W, H, U, UP, 0);
  __syncthreads();
  float f[MAXF], h[MAXF], gy[MAXF], gs[MAXF], dft[MAXF];
#pragma unroll
  for (int j = 0; j < MAXF; ++j) {
    f[j] = j < H ? urow[j] : 0.0f;
    gs[j] = dft[j] = 0.0f;
  }
  __syncthreads();

  for (int k = K - 1; k >= 0; --k) {
    const float* s_in = k > 0 ? traj + ((size_t)(k - 1) * B + b) * W * D : s0 + row0 * D;
    stage_in(s_in, W, D, S, DP, 0);
    stage_in(g_traj + ((size_t)k * B + b) * W * H, W, H, U, UP, 0);
    __syncthreads();
    // u = [Ws; Wa] @ s_in: Ws rows into h, Wa rows into U[t][H:]
    {
      float ua[MAXF];
#pragma unroll
      for (int j = 0; j < MAXF; ++j) h[j] = ua[j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float x = S[t * DP + d];
#pragma unroll
        for (int j = 0; j < MAXF; ++j) {
          if (j < H) {
            h[j] = fmaf(w[j * D + d], x, h[j]);
            ua[j] = fmaf(w[(H + j) * D + d], x, ua[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < H) urow[H + j] = ua[j];
    }
    __syncthreads();
    // h[t] = u[t, :H] + sum_src adjT[src][t] * u[src, H:] + fT, reading column t
    {
      float acc[MAXF];
#pragma unroll
      for (int j = 0; j < MAXF; ++j) acc[j] = 0.0f;
      for (int src = 0; src < W; ++src) {
        const float a = adj[src * (W + 1) + t];
        const float* r = U + src * UP + H;
#pragma unroll
        for (int j = 0; j < MAXF; ++j)
          if (j < H) acc[j] = fmaf(a, r[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < MAXF; ++j) {
        h[j] = h[j] + acc[j] + f[j];
        gy[j] = j < H ? urow[j] + gs[j] : 0.0f;
      }
    }
    __syncthreads();  // every thread is done with U[:, H:]
    if (has_aff) {
      // this block's daff += (sum_n gy * act(h), sum_n gy)
#pragma unroll
      for (int j = 0; j < MAXF; ++j) {
        if (j < H) {
          urow[j] = gy[j] * activate(act, h[j]);
          urow[H + j] = gy[j];
        }
      }
      __syncthreads();
      for (int o = t; o < 2 * H; o += blockDim.x) {
        float acc = 0.0f;
        for (int n = 0; n < W; ++n) acc += U[n * UP + o];
        daff[o] += acc;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < H) gy[j] *= sc[j];
    }
    // dh = gy * act'(h) into U[t][:H]; h holds dh from here on
#pragma unroll
    for (int j = 0; j < MAXF; ++j) {
      h[j] = j < H ? gy[j] * act_grad(act, h[j]) : 0.0f;
      dft[j] += h[j];
      if (j < H) urow[j] = h[j];
    }
    __syncthreads();
    // dua[t] = sum_dst adjT[t][dst] * dh[dst], reading row t, into U[t][H:]
#pragma unroll
    for (int j = 0; j < MAXF; ++j) gy[j] = 0.0f;
    for (int dst = 0; dst < W; ++dst) {
      const float a = adj[t * (W + 1) + dst];
      const float* r = U + dst * UP;
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < H) gy[j] = fmaf(a, r[j], gy[j]);
    }
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < H) urow[H + j] = gy[j];
    __syncthreads();
    // this block's dw2[j][d] += sum_n du[n][j] * s_in[n][d]
    for (int o = t; o < 2 * H * D; o += blockDim.x) {
      const int j = o / D, d = o % D;
      float acc = 0.0f;
      for (int n = 0; n < W; ++n) acc = fmaf(U[n * UP + j], S[n * DP + d], acc);
      dw2[o] += acc;
    }
    // gs = du @ [Ws; Wa]
#pragma unroll
    for (int d = 0; d < MAXF; ++d) gs[d] = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXF; ++j) {
      if (j < H) {
#pragma unroll
        for (int d = 0; d < MAXF; ++d) {
          if (d < D) {
            gs[d] = fmaf(h[j], w[j * D + d], gs[d]);
            gs[d] = fmaf(gy[j], w[(H + j) * D + d], gs[d]);
          }
        }
      }
    }
    __syncthreads();  // S and U are restaged by the next reverse step
  }
#pragma unroll
  for (int j = 0; j < MAXF; ++j) {
    if (j < H) {
      urow[j] = dft[j];
      S[t * DP + j] = gs[j];
    }
  }
  __syncthreads();
  stage_out(dfT_out + row0 * H, W, H, U, UP);
  stage_out(gs_out + row0 * D, W, D, S, DP);
}

size_t bwd_smem(int W, int D) {
  return sizeof(float) * ((size_t)W * (W + 1) + (size_t)W * (D | 1) +
                          (size_t)W * ((2 * D) | 1) + 2 * (size_t)D * D + D);
}

template <int MAXF>
cudaError_t launch(const float* adjT, const float* s0, const float* traj, const float* fT,
                   const float* w2, const float* aff, const float* g_traj, float* gs,
                   float* dw2, float* dfT, float* daff, int B, int W, int D, int K, int act,
                   cudaStream_t stream) {
  const size_t bytes = bwd_smem(W, D);
  cudaError_t err = set_smem(loop_bwd_kernel<MAXF>, bytes);
  if (err != cudaSuccess) return err;
  loop_bwd_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s0, traj, fT, w2, aff, g_traj, gs, dw2,
                                                  dfT, daff, B, W, D, K, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0/fT [B, W, D], traj/g_traj [K, B, W, D], w2 [2D, D],
// aff [2, D] (null: no affine) -> gs, dfT [B, W, D], dw2 [B, 2D, D] and
// daff [B, 2, D] (with aff) per-block partials. Returns a cudaError_t code.
int gnn_propagation_loop_bwd(const float* adjT, const float* s0, const float* traj,
                             const float* fT, const float* w2, const float* aff,
                             const float* g_traj, float* gs, float* dw2, float* dfT,
                             float* daff, int B, int W, int D, int K, int act, void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || (aff != nullptr && daff == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch<16>(adjT, s0, traj, fT, w2, aff, g_traj, gs, dw2, dfT, daff, B, W, D, K, act,
                        st);
    case 32:
      return launch<32>(adjT, s0, traj, fT, w2, aff, g_traj, gs, dw2, dfT, daff, B, W, D, K, act,
                        st);
    case 64:
      return launch<64>(adjT, s0, traj, fT, w2, aff, g_traj, gs, dw2, dfT, daff, B, W, D, K, act,
                        st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
