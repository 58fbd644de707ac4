// Eval propagation kernels of the GNN fixed-point loop for Hopper (sm_90a),
// in plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K3 _loop_kernel_T (launched by _fused_loop_impl) -> gnn_propagation_loop
//   K4 _step_kernel_T (launched by _fused_fwd_impl)  -> gnn_propagation_step
//
// One iteration on one W-node block, node-major rows (D = width of the state
// read, H = width of the state written):
//   U   = s @ [Ws; Wa]^T               [W, 2H]
//   A   = adjT^T @ U[:, H:]            A[dst] = sum_src adjT[src, dst] * U[src, H:]
//   h   = U[:, :H] + A + fT (+ rT)
//   out = act(h) * scale + shift       (inference BatchNorm as an affine)
// K3 runs all K iterations of a residual-free block inside one CTA on the
// block adjacency loaded into shared memory once, and writes the state after
// every iteration (traj) and the pre-update movement flags (margins). K4 runs
// one iteration of a residual-coupled block with the residual term rT.
//
// Design: one CTA per block, one thread per destination node (blockDim == W).
// A thread keeps its own node's state, old state, feature term and
// accumulators in registers (MAXF-wide arrays, unrolled with width guards), so
// only U[:, H:] is shared: the adjacency contraction reads a column of adjT
// (consecutive threads, consecutive addresses) and broadcasts a row of
// U[:, H:] as float4s. Row blocks of s0/fT/traj move between device memory
// and registers through a staging tile, so every global access is contiguous.
//
// Bound: a launch reads each block's adjacency (W*W*4 bytes, 64 KiB at
// W = 128) once; K3 also reads s0/fT and writes K trajectories. The dense
// contraction costs 2*H*W*W flops per block and iteration, while the sparse
// adjacency (about 2 arcs per node on MUTAG-shaped blocks) needs 2*H*nnz, so
// the least time of the work is set by its bytes. This first version stages
// the adjacency synchronously, fits 2 CTAs per SM and does the dense
// contraction: its time is set by shared-memory traffic and FMAs, not bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxW = 128;

enum Activation { kLinear = 0, kTanh = 1, kRelu = 2, kSelu = 3 };

__device__ __forceinline__ float activate(int act, float x) {
  switch (act) {
    case kTanh:
      return tanhf(x);
    case kRelu:
      return fmaxf(x, 0.0f);
    case kSelu:
      // exp(min(x, 0)) - 1, not expm1: the formula of pallas_fused.py::_ACTS
      return 1.0507009873554805f *
             (x > 0.0f ? x : 1.6732632423543772f * (expf(fminf(x, 0.0f)) - 1.0f));
    default:
      return x;
  }
}

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

// K3: all K iterations of residual-free blocks (H == D).
template <int MAXF>
__global__ void __launch_bounds__(kMaxW)
loop_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
            const float* __restrict__ fT, const float* __restrict__ w2,
            const float* __restrict__ aff, const float* __restrict__ nm,
            float* __restrict__ traj, float* __restrict__ marg,
            int B, int W, int D, int K, float thr, int act) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve<MAXF>(reinterpret_cast<float*>(smem_raw), W, D, D);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  load_block(sm, adjT + row0 * W, w2, aff, W, D, D);

  float s[MAXF], f[MAXF], s_old[MAXF], y[MAXF];
  load_rows<MAXF>(s0 + row0 * D, W, D, sm.stage, s);
  load_rows<MAXF>(fT + row0 * D, W, D, sm.stage, f);
  const float nmv = nm[row0 + t];
#pragma unroll
  for (int d = 0; d < MAXF; ++d) s_old[d] = 1.0f;

  for (int k = 0; k < K; ++k) {
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
    marg[(size_t)k * B * W + row0 + t] = sqrtf(dist2) > thr * sqrtf(norm2) ? nmv : 0.0f;

    iterate<MAXF>(sm, W, D, D, act, s, f, false, f, y);
#pragma unroll
    for (int d = 0; d < MAXF; ++d) {
      s_old[d] = s[d];
      s[d] = y[d];
    }
    store_rows<MAXF>(traj + ((size_t)k * B + b) * W * D, W, D, sm.stage, s);
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

// Register-array width for a feature width: 16, 32 or 64 (0 = unsupported).
// The 64-wide variants (and step_kernel<32>) spill to local memory under 128
// threads per CTA; chip_smoke.py holds every variant against its plain version.
int width_class(int F) { return F <= 16 ? 16 : F <= 32 ? 32 : F <= 64 ? 64 : 0; }

bool block_ok(int B, int W) { return B > 0 && W >= 32 && W <= kMaxW && W % 32 == 0; }

template <int MAXF>
cudaError_t launch_loop(const float* adjT, const float* s0, const float* fT,
                        const float* w2, const float* aff, const float* nm, float* traj,
                        float* marg, int B, int W, int D, int K, float thr, int act,
                        cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<MAXF>(W, D, D);
  cudaError_t err = cudaFuncSetAttribute(loop_kernel<MAXF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  loop_kernel<MAXF><<<B, W, bytes, stream>>>(adjT, s0, fT, w2, aff, nm, traj, marg, B, W,
                                             D, K, thr, act);
  return cudaGetLastError();
}

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

// adjT [B, W, W], s0/fT [B, W, D], w2 [2D, D], aff [2, D], nm [B, W]
// -> traj [K, B, W, D], marg [K, B, W]. Returns a cudaError_t code.
int gnn_propagation_loop(const float* adjT, const float* s0, const float* fT,
                         const float* w2, const float* aff, const float* nm, float* traj,
                         float* marg, int B, int W, int D, int K, float thr, int act,
                         void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width_class(D)) {
    case 16:
      return launch_loop<16>(adjT, s0, fT, w2, aff, nm, traj, marg, B, W, D, K, thr, act, st);
    case 32:
      return launch_loop<32>(adjT, s0, fT, w2, aff, nm, traj, marg, B, W, D, K, thr, act, st);
    case 64:
      return launch_loop<64>(adjT, s0, fT, w2, aff, nm, traj, marg, B, W, D, K, thr, act, st);
    default:
      return cudaErrorInvalidValue;
  }
}

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
