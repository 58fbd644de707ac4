// K5_bf16, the reverse of K3_bf16 (the one-layer eval loop on a bf16 block
// adjacency), for Hopper (sm_90a): all K reverse iterations of residual-free
// blocks in one launch, gnn_tpu's _loop_bwd_kernel with hp false
// (pallas_fused.py:517-583). It trains the clean one-layer route on a bf16
// batch.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K5 _loop_bwd_kernel with a bf16 adjacency (hp false, launched by
//      _loop_bwd_impl) -> gnn_propagation_loop_bwd_bf16
// The f32 K5 is in eval_loop_bwd.cu, K3_bf16 in eval_loop_bf16.cu.
//
// Reverse iteration k, from s_in = s_{k} (s0 at k = 0), w2 = [Ws; Wa]
// [2H, D] with H = D, bf as in bf16.cuh:
//   recompute h = (U_s + adjT^T @ bf(U_a)) + fT,  U = bf(s_in) @ bf(w2)^T
//   gy  = g_traj[k] + gs; daff += (sum gy * act(h), sum gy); gy *= scale
//   dh  = gy * act'(h);  dfT += dh
//   dua = adjT @ bf(dh)                     over the destinations ascending
//   du  = [dh | dua];  dw2 += du^T s_in     (f32, s_in unrounded)
//   gs  = bf(du) @ bf(w2)                   unit h's two rows in turn
// Every sum runs over its index ascending, one f32 add a term (products of
// bf values are exact, so fmaf adds them once rounded), dw2 and daff node by
// node with each product rounded, the activation and its derivative through
// act64 / act_grad64: a launch gives the plain version's bits
// (ops/fused.py::propagation_loop_bwd_bf16_ref), the per-block partials
// included.
//
// Design: bf16.cuh's reverse CTA, one a block, the bf16 adjacency staged once
// a launch for all K reverse iterations; the H units in chunks of
// kBf16Chunk: U's two halves of the chunk and h (bf16_u_chunk,
// bf16_h0_chunk, K3_bf16's), then daff, dh and dfT, dua, and the chunk's
// terms of dw2 and gs. gy lives in the h1 rows and gs in the gs rows until
// the end; dw2, dfT and daff are the block's slices of the outputs, which
// the wrapper zeroes and each thread adds its own entries to. No atomics: a
// repeat launch is bit-identical.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block), s0, fT, the K
// states and cotangents read once, the outputs written once; the operations
// of K3_bf16's iteration (2*2H*D a node, 2*H an arc) and the reverse
// products (dua 2*H an arc, dw2 2*2H*D fp32 and gs 2*2H*D a node) a
// reverse iteration at the dense bf16 tensor-core rate
// (chip_smoke.py::bf16_bounds). The CUDA-core FMAs over the dense staged
// adjacency run far from it; tensor-core tiles are a later redesign's.

#include "bf16.cuh"

namespace {

using namespace gnn;

__global__ void __launch_bounds__(kBf16Threads)
loop_bwd_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                     const float* __restrict__ traj, const float* __restrict__ fT,
                     const float* __restrict__ w2, const float* __restrict__ aff,
                     const float* __restrict__ g_traj, float* __restrict__ gs_out,
                     float* __restrict__ dw2, float* __restrict__ dfT, float* __restrict__ daff,
                     int B, int W, int D, int K, int act) {
  extern __shared__ float4 smem_f4[];
  const Bf16Smem m = bf16_layout(smem_f4, W, D, true);
  const int b = blockIdx.x;
  const int WD = W * D, H = D, CH = kBf16Chunk;
  float* gy = m.h1;
  float* dw2_b = dw2 + (size_t)b * 2 * H * D;
  for (int i = threadIdx.x; i < WD; i += blockDim.x) m.gs[i] = 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    const float* s_in = k ? traj + (size_t)(k - 1) * B * WD : s0;
    __syncthreads();  // the last iteration's gs terms are done
    if (k == K - 1) {
      bf16_stage(m, adjT, s_in, b, W, D);
    } else {
      for (int i = threadIdx.x; i < WD; i += blockDim.x) m.s[i] = s_in[(size_t)b * WD + i];
    }
    // gy = g_traj[k] + gs; gs restarts
    const float* g = g_traj + ((size_t)k * B + b) * WD;
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      gy[i] = __fadd_rn(__ldg(g + i), m.gs[i]);
      m.gs[i] = 0.0f;
    }
    for (int h0 = 0; h0 < H; h0 += CH) {
      const int cw = min(CH, H - h0);
      __syncthreads();  // s and gy ready; the last chunk's terms read c1, c2
      bf16_u_chunk(m, w2, W, D, H, h0, cw);
      __syncthreads();
      bf16_h0_chunk(m, fT, nullptr, b, W, H, h0, cw, act, m.c0, nullptr, false);
      __syncthreads();
      if (daff != nullptr) {
        for (int h = threadIdx.x; h < cw; h += blockDim.x) {
          float sy = 0.0f, sg = 0.0f;
          for (int n = 0; n < W; ++n) {
            const float v = gy[n * D + h0 + h];
            sy = __fadd_rn(sy, __fmul_rn(v, act64(act, m.c0[n * CH + h])));
            sg = __fadd_rn(sg, v);
          }
          daff[((size_t)b * 2) * D + h0 + h] += sy;
          daff[((size_t)b * 2 + 1) * D + h0 + h] += sg;
        }
      }
      // dh = gy (* scale) * act'(h) into c1; dfT += dh
      for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
        const int n = i / cw, h = i % cw;
        float v = gy[n * D + h0 + h];
        if (aff != nullptr) v = __fmul_rn(v, __ldg(aff + h0 + h));
        const float dh = __fmul_rn(v, act_grad64(act, m.c0[n * CH + h]));
        m.c1[n * CH + h] = dh;
        float* t = dfT + ((size_t)b * W + n) * H + h0 + h;
        *t = __fadd_rn(*t, dh);
      }
      __syncthreads();
      // dua = adjT @ bf(dh), over the destinations ascending, into c2
      for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
        const int src = i / cw, h = i % cw;
        float acc = 0.0f;
        for (int dst = 0; dst < W; ++dst)
          acc = fmaf(bf16_value(m.adj[src * W + dst]), bf(m.c1[dst * CH + h]), acc);
        m.c2[src * CH + h] = acc;
      }
      __syncthreads();
      // dw2 += du^T s_in; gs += bf(du) @ bf(w2)
      for (int i = threadIdx.x; i < 2 * cw * D; i += blockDim.x) {
        const bool a = i >= cw * D;
        const int r = a ? i - cw * D : i, h = r / D, d = r % D;
        const float* du = a ? m.c2 : m.c1;
        float acc = 0.0f;
        for (int n = 0; n < W; ++n) acc = __fadd_rn(acc, __fmul_rn(du[n * CH + h], m.s[n * D + d]));
        dw2_b[(size_t)((a ? H : 0) + h0 + h) * D + d] += acc;
      }
      for (int i = threadIdx.x; i < WD; i += blockDim.x) {
        const int n = i / D, d = i % D;
        float acc = m.gs[i];
        for (int h = 0; h < cw; ++h) {
          acc = fmaf(bf(m.c1[n * CH + h]), bf(__ldg(w2 + (size_t)(h0 + h) * D + d)), acc);
          acc = fmaf(bf(m.c2[n * CH + h]), bf(__ldg(w2 + (size_t)(H + h0 + h) * D + d)), acc);
        }
        m.gs[i] = acc;
      }
    }
  }
  __syncthreads();
  float* o = gs_out + (size_t)b * WD;
  for (int i = threadIdx.x; i < WD; i += blockDim.x) o[i] = m.gs[i];
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 [B, W, D], traj and g_traj [K, B, W, D], fT
// [B, W, D], w2 [2D, D], aff [2, D] (nullable) -> gs [B, W, D]; dw2
// [B, 2D, D], dfT [B, W, D] and daff [B, 2, D] (null without aff)
// accumulated into outputs the caller zeroed. Returns a cudaError_t code.
int gnn_propagation_loop_bwd_bf16(const uint16_t* adjT, const float* s0, const float* traj,
                                  const float* fT, const float* w2, const float* aff,
                                  const float* g_traj, float* gs, float* dw2, float* dfT,
                                  float* daff, int B, int W, int D, int K, int act,
                                  void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0) return cudaErrorInvalidValue;
  if ((aff == nullptr) != (daff == nullptr)) return cudaErrorInvalidValue;
  const size_t bytes = bf16_smem(W, D, true);
  cudaError_t err = set_smem(loop_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  loop_bwd_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, fT, w2, aff, g_traj, gs, dw2, dfT, daff, B, W, D, K, act);
  return cudaGetLastError();
}

}  // extern "C"
