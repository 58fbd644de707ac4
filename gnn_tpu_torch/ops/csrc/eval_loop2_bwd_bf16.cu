// K11_bf16, the reverse of K10_bf16 (the two-layer eval loop on a bf16
// block adjacency), for Hopper (sm_90a): all K reverse iterations of
// residual-free blocks in one launch, gnn_tpu's _loop2_bwd_kernel with
// hp false.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K11 _loop2_bwd_kernel with a bf16 adjacency (hp false, launched by
//   _loop2_bwd) -> gnn_propagation_loop2_bwd_bf16
// The f32 K11 is in eval_loop2_bwd.cu.
//
// Reverse iteration k, from s_in = s_{k} (s0 at k = 0), bf as in bf16.cuh:
//   recompute h0, y0 = act0(h0), h1 with the forward's rounding
//   gy  = g_traj[k] + gs; daff += (sum gy * act1(h1), sum gy); gy *= scale
//   dh1 = gy * act1'(h1);  db1 += sum dh1;  dw1 += dh1^T y0 (f32)
//   dh0 = (bf(dh1) @ bf(w1)) * act0'(h0);   dfT += dh0
//   dua = adjT @ bf(dh0)                    (over the destinations)
//   du  = [dh0 | dua];  dw20 += du^T s_in (f32)
//   gs  = bf(du) @ bf(w20)                  (unit h's two rows in turn)
// every sum of products of bf values over its index ascending, as the plain
// version (ops/fused2.py::propagation_loop2_bwd_bf16_ref) sums them.
//
// Design: bf16.cuh's CTA, one a block. A reverse iteration runs the
// forward's chunks twice: once for h1 (its terms need every chunk), then
// again for each chunk's h0 and y0 beside dh0, dua and the chunk's terms of
// dw1, dw20 and gs. dw20, dw1, db1, dfT and daff are the block's slices of
// the outputs, which the wrapper zeroes and each thread adds its own entries
// to; gs lives in shared memory until the end.
//
// Bound: as K10_bf16's (the same staging), the operations of a forward
// twice and the reverse products 2*W*(H1*D + W*H1 + 2H1*D) a block and
// iteration (chip_smoke.py::bf16_bounds).

#include "bf16.cuh"

namespace {

using namespace gnn;

__global__ void __launch_bounds__(kBf16Threads)
loop2_bwd_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                      const float* __restrict__ traj, const float* __restrict__ fT,
                      const float* __restrict__ w20, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ aff,
                      const float* __restrict__ g_traj, float* __restrict__ gs_out,
                      float* __restrict__ dw20, float* __restrict__ dw1, float* __restrict__ db1,
                      float* __restrict__ dfT, float* __restrict__ daff, int B, int W, int D,
                      int H1, int K, int act0, int act1) {
  extern __shared__ float4 smem_f4[];
  const Bf16Smem m = bf16_layout(smem_f4, W, D, true);
  const int b = blockIdx.x;
  const int WD = W * D;
  float* dw20_b = dw20 + (size_t)b * 2 * H1 * D;
  float* dw1_b = dw1 + (size_t)b * D * H1;
  for (int i = threadIdx.x; i < WD; i += blockDim.x) m.gs[i] = 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    const float* s_in = k ? traj + (size_t)(k - 1) * B * WD : s0;
    if (k == K - 1) {
      bf16_stage(m, adjT, s_in, b, W, D);
    } else {
      for (int i = threadIdx.x; i < WD; i += blockDim.x) m.s[i] = s_in[(size_t)b * WD + i];
    }
    // ---- the forward's h1, before its bias
    for (int i = threadIdx.x; i < WD; i += blockDim.x) m.h1[i] = 0.0f;
    for (int h0 = 0; h0 < H1; h0 += kBf16Chunk) {
      const int cw = min(kBf16Chunk, H1 - h0);
      __syncthreads();
      bf16_u_chunk(m, w20, W, D, H1, h0, cw);
      __syncthreads();
      bf16_h0_chunk(m, fT, nullptr, b, W, H1, h0, cw, act0, nullptr, m.c0, true);
      __syncthreads();
      bf16_h1_chunk(m, w1, m.c0, true, W, D, H1, h0, cw);
    }
    __syncthreads();
    // ---- gy, the affine's cotangent, dh1 (into h1) and db1; gs restarts
    const float* g = g_traj + ((size_t)k * B + b) * WD;
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      m.h1[i] = __fadd_rn(m.h1[i], __ldg(b1 + i % D));
      m.gs[i] = __fadd_rn(__ldg(g + i), m.gs[i]);
    }
    __syncthreads();
    if (daff != nullptr) {
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float sy = 0.0f, sg = 0.0f;
        for (int n = 0; n < W; ++n) {
          const float gy = m.gs[n * D + d];
          sy = __fadd_rn(sy, __fmul_rn(gy, act64(act1, m.h1[n * D + d])));
          sg = __fadd_rn(sg, gy);
        }
        daff[((size_t)b * 2) * D + d] += sy;
        daff[((size_t)b * 2 + 1) * D + d] += sg;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      float gy = m.gs[i];
      if (aff != nullptr) gy = __fmul_rn(gy, __ldg(aff + i % D));
      m.h1[i] = __fmul_rn(gy, act_grad64(act1, m.h1[i]));
      m.gs[i] = 0.0f;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float sum = 0.0f;
      for (int n = 0; n < W; ++n) sum = __fadd_rn(sum, m.h1[n * D + d]);
      db1[(size_t)b * D + d] += sum;
    }
    // ---- the chunks again: h0, y0, dh0, dua and their terms
    for (int h0 = 0; h0 < H1; h0 += kBf16Chunk) {
      const int cw = min(kBf16Chunk, H1 - h0);
      __syncthreads();
      bf16_u_chunk(m, w20, W, D, H1, h0, cw);
      __syncthreads();
      bf16_h0_chunk(m, fT, nullptr, b, W, H1, h0, cw, act0, m.c0, m.c1, false);
      __syncthreads();
      // dh0 = (bf(dh1) @ bf(w1)) * act0'(h0) into c2; dfT += dh0
      for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
        const int n = i / cw, h = i % cw;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d)
          acc = fmaf(bf(m.h1[n * D + d]), bf(__ldg(w1 + (size_t)d * H1 + h0 + h)), acc);
        const float dh0 = __fmul_rn(acc, act_grad64(act0, m.c0[n * kBf16Chunk + h]));
        m.c2[n * kBf16Chunk + h] = dh0;
        float* t = dfT + ((size_t)b * W + n) * H1 + h0 + h;
        *t = __fadd_rn(*t, dh0);
      }
      __syncthreads();
      // dua = adjT @ bf(dh0), over the destinations ascending, into ua
      for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
        const int src = i / cw, h = i % cw;
        float acc = 0.0f;
        for (int dst = 0; dst < W; ++dst)
          acc = fmaf(bf16_value(m.adj[src * W + dst]), bf(m.c2[dst * kBf16Chunk + h]), acc);
        m.ua[src * kBf16Chunk + h] = acc;
      }
      __syncthreads();
      // dw1 += dh1^T y0; dw20 += du^T s_in; gs += bf(du) @ bf(w20)
      for (int i = threadIdx.x; i < D * cw; i += blockDim.x) {
        const int d = i / cw, h = i % cw;
        float acc = 0.0f;
        for (int n = 0; n < W; ++n)
          acc = __fadd_rn(acc, __fmul_rn(m.h1[n * D + d], m.c1[n * kBf16Chunk + h]));
        dw1_b[(size_t)d * H1 + h0 + h] += acc;
      }
      for (int i = threadIdx.x; i < 2 * cw * D; i += blockDim.x) {
        const bool a = i >= cw * D;
        const int r = a ? i - cw * D : i, h = r / D, d = r % D;
        const float* du = a ? m.ua : m.c2;
        float acc = 0.0f;
        for (int n = 0; n < W; ++n)
          acc = __fadd_rn(acc, __fmul_rn(du[n * kBf16Chunk + h], m.s[n * D + d]));
        dw20_b[(size_t)((a ? H1 : 0) + h0 + h) * D + d] += acc;
      }
      for (int i = threadIdx.x; i < WD; i += blockDim.x) {
        const int n = i / D, d = i % D;
        float acc = m.gs[i];
        for (int h = 0; h < cw; ++h) {
          acc = fmaf(bf(m.c2[n * kBf16Chunk + h]), bf(__ldg(w20 + (size_t)(h0 + h) * D + d)),
                     acc);
          acc = fmaf(bf(m.ua[n * kBf16Chunk + h]),
                     bf(__ldg(w20 + (size_t)(H1 + h0 + h) * D + d)), acc);
        }
        m.gs[i] = acc;
      }
    }
    __syncthreads();
  }
  float* o = gs_out + (size_t)b * WD;
  for (int i = threadIdx.x; i < WD; i += blockDim.x) o[i] = m.gs[i];
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 [B, W, D], traj and g_traj [K, B, W, D], fT
// [B, W, H1], w20 [2H1, D], w1 [D, H1], b1 [D], aff [2, D] (nullable) ->
// gs [B, W, D]; dw20 [B, 2H1, D], dw1 [B, D, H1], db1 [B, D], dfT
// [B, W, H1] and daff [B, 2, D] (null without aff) accumulated into outputs
// the caller zeroed. Returns a cudaError_t code.
int gnn_propagation_loop2_bwd_bf16(const uint16_t* adjT, const float* s0, const float* traj,
                                   const float* fT, const float* w20, const float* w1,
                                   const float* b1, const float* aff, const float* g_traj,
                                   float* gs, float* dw20, float* dw1, float* db1, float* dfT,
                                   float* daff, int B, int W, int D, int H1, int K, int act0,
                                   int act1, void* stream) {
  if (!block_ok(B, W) || D <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  if ((aff == nullptr) != (daff == nullptr)) return cudaErrorInvalidValue;
  const size_t bytes = bf16_smem(W, D, true);
  cudaError_t err = set_smem(loop2_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  loop2_bwd_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, fT, w20, w1, b1, aff, g_traj, gs, dw20, dw1, db1, dfT, daff, B, W, D, H1,
      K, act0, act1);
  return cudaGetLastError();
}

}  // extern "C"
