// The one-iteration eval kernel of the GNN fixed-point loop for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K4 _step_kernel_T (launched by _fused_fwd_impl)  -> gnn_propagation_step
// K3, all K iterations of the residual-free blocks, is in eval_loop.cu.
//
// One iteration on one W-node block, node-major rows (D = width of the state
// read, H = width of the state written):
//   U   = s @ [Ws; Wa]^T               [W, 2H]
//   A   = adjT^T @ U[:, H:]            A[dst] = sum_src adjT[src, dst] * U[src, H:]
//   h   = U[:, :H] + A + fT (+ rT)
//   out = act(h) * scale + shift       (inference BatchNorm as an affine)
// K4 runs one iteration of a residual-coupled block with the residual term
// rT.
//
// Design: one CTA per block, one thread per destination node (blockDim == W).
// A thread keeps its own node's state, feature term and accumulators in
// registers (MAXF-wide arrays, unrolled with width guards), so only
// U[:, H:] is shared: the adjacency contraction reads a column of adjT
// (consecutive threads, consecutive addresses) and broadcasts a row of
// U[:, H:] as float4s. Row blocks of s/fT/rT/out move between device memory
// and registers through a staging tile, so every global access is
// contiguous.
//
// Bound: a launch reads each block's adjacency (W*W*4 bytes, 64 KiB at
// W = 128) once. The dense contraction costs 2*H*W*W flops per block, while
// the sparse adjacency (about 2 arcs per node on MUTAG-shaped blocks) needs
// 2*H*nnz, so the least time of the work is set by its bytes. This version
// stages the adjacency synchronously, fits 2 CTAs per SM and does the dense
// contraction: its time is set by shared-memory traffic and FMAs, not bytes.

#include "common.cuh"

namespace {

using namespace gnn;

struct Smem {
  float* adj;    // [W][W]    adjT[src][dst]
  float* ua;     // [W][MAXF] U[:, H:], zero beyond H
  float* stage;  // [W * MAXF] staging tile for row blocks
  float* w2;     // [2H][D]
  float* aff;    // [2][H]    scale; shift
};

template <int MAXF>
__host__ __device__ size_t smem_floats(int W, int D, int H) {
  return (size_t)W * W + 2 * (size_t)W * MAXF + 2 * (size_t)H * D + 2 * (size_t)H;
}

template <int MAXF>
__device__ Smem carve(float* base, int W, int D, int H) {
  Smem s;
  s.adj = base;
  s.ua = s.adj + W * W;
  s.stage = s.ua + W * MAXF;
  s.w2 = s.stage + W * MAXF;
  s.aff = s.w2 + 2 * H * D;
  return s;
}

__device__ void load_block(const Smem& sm, const float* __restrict__ adjT_b,
                           const float* __restrict__ w2, const float* __restrict__ aff,
                           int W, int D, int H) {
  const float4* src4 = reinterpret_cast<const float4*>(adjT_b);
  float4* dst4 = reinterpret_cast<float4*>(sm.adj);
  for (int i = threadIdx.x; i < W * W / 4; i += blockDim.x) dst4[i] = src4[i];
  for (int i = threadIdx.x; i < 2 * H * D; i += blockDim.x) sm.w2[i] = w2[i];
  for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) sm.aff[i] = aff[i];
  __syncthreads();
}

// Contiguous [W, F] row block -> this thread's row in registers.
template <int MAXF>
__device__ void load_rows(const float* __restrict__ g, int W, int F, float* stage,
                          float (&r)[MAXF]) {
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) stage[i] = g[i];
  __syncthreads();
#pragma unroll
  for (int f = 0; f < MAXF; ++f) r[f] = f < F ? stage[threadIdx.x * F + f] : 0.0f;
  __syncthreads();
}

// This thread's row in registers -> contiguous [W, F] row block.
template <int MAXF>
__device__ void store_rows(float* __restrict__ g, int W, int F, float* stage,
                           const float (&r)[MAXF]) {
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < F) stage[threadIdx.x * F + f] = r[f];
  __syncthreads();
  for (int i = threadIdx.x; i < W * F; i += blockDim.x) g[i] = stage[i];
  __syncthreads();
}

// One propagation iteration for this thread's node: y = act(h)*scale + shift.
template <int MAXF>
__device__ void iterate(const Smem& sm, int W, int D, int H, int act,
                        const float (&s)[MAXF], const float (&f)[MAXF], bool has_res,
                        const float (&r)[MAXF], float (&y)[MAXF]) {
  const int t = threadIdx.x;
  float us[MAXF];
#pragma unroll
  for (int h = 0; h < MAXF; ++h) {
    float a = 0.0f, b = 0.0f;
    if (h < H) {
      const float* ws = sm.w2 + h * D;
      const float* wa = sm.w2 + (H + h) * D;
#pragma unroll
      for (int d = 0; d < MAXF; ++d) {
        if (d < D) {
          a = fmaf(ws[d], s[d], a);
          b = fmaf(wa[d], s[d], b);
        }
      }
    }
    us[h] = a;
    sm.ua[t * MAXF + h] = b;
  }
  __syncthreads();

  float acc[MAXF];
#pragma unroll
  for (int h = 0; h < MAXF; ++h) acc[h] = 0.0f;
  const float* adj_col = sm.adj + t;
  for (int src = 0; src < W; ++src) {
    const float a = adj_col[src * W];
    const float4* row = reinterpret_cast<const float4*>(sm.ua + src * MAXF);
#pragma unroll
    for (int q = 0; q < MAXF / 4; ++q) {
      const float4 v = row[q];
      acc[4 * q + 0] = fmaf(v.x, a, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, a, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, a, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, a, acc[4 * q + 3]);
    }
  }
  __syncthreads();  // ua is rewritten by the next iteration

#pragma unroll
  for (int h = 0; h < MAXF; ++h) {
    float v = 0.0f;
    if (h < H) {
      float pre = us[h] + acc[h] + f[h];
      if (has_res) pre += r[h];
      v = activate(act, pre) * sm.aff[h] + sm.aff[H + h];
    }
    y[h] = v;
  }
}

// K4: one iteration of residual-coupled blocks; rT may be null.
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
step_kernel(const float* __restrict__ adjT, const float* __restrict__ s,
            const float* __restrict__ rT, const float* __restrict__ fT,
            const float* __restrict__ w2, const float* __restrict__ aff,
            float* __restrict__ out, int B, int W, int D, int H, int act) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve<MAXF>(reinterpret_cast<float*>(smem_raw), W, D, H);
  const size_t row0 = (size_t)blockIdx.x * W;
  load_block(sm, adjT + row0 * W, w2, aff, W, D, H);

  float sv[MAXF], f[MAXF], r[MAXF], y[MAXF];
  load_rows<MAXF>(s + row0 * D, W, D, sm.stage, sv);
  load_rows<MAXF>(fT + row0 * H, W, H, sm.stage, f);
  const bool has_res = rT != nullptr;
  if (has_res) {
    load_rows<MAXF>(rT + row0 * H, W, H, sm.stage, r);
  } else {
#pragma unroll
    for (int h = 0; h < MAXF; ++h) r[h] = 0.0f;
  }
  iterate<MAXF>(sm, W, D, H, act, sv, f, has_res, r, y);
  store_rows<MAXF>(out + row0 * H, W, H, sm.stage, y);
}

// The 64-wide variant (and step_kernel<32>) spill to local memory under 128
// threads per CTA; chip_smoke.py holds every variant against its plain version.

template <int MAXF>
cudaError_t launch_step(const float* adjT, const float* s, const float* rT,
                        const float* fT, const float* w2, const float* aff, float* out,
                        int B, int W, int D, int H, int act, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<MAXF>(W, D, H);
  cudaError_t err = cudaFuncSetAttribute(step_kernel<MAXF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  step_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s, rT, fT, w2, aff, out, B, W, D, H,
                                             act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// adjT [B, W, W], s [B, W, D], rT (nullable)/fT [B, W, H], w2 [2H, D],
// aff [2, H] -> out [B, W, H]. Returns a cudaError_t code.
int gnn_propagation_step(const float* adjT, const float* s, const float* rT,
                         const float* fT, const float* w2, const float* aff, float* out,
                         int B, int W, int D, int H, int act, void* stream) {
  if (!block_ok(B, W) || D <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D > H ? D : H)) {
    case 16:
      return launch_step<16>(adjT, s, rT, fT, w2, aff, out, B, W, D, H, act, st);
    case 32:
      return launch_step<32>(adjT, s, rT, fT, w2, aff, out, B, W, D, H, act, st);
    case 64:
      return launch_step<64>(adjT, s, rT, fT, w2, aff, out, B, W, D, H, act, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* gnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
