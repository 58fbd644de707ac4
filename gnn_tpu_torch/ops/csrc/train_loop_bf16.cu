// K7_bf16, K8_bf16 and K6_bf16, the one-layer dropout-training kernels on a
// bf16 block adjacency, for Hopper (sm_90a): gnn_tpu's `hp = False` branch
// of _loop_train_kernel_T, _loop_train_bwd_kernel and _train_kernel_T
// (pallas_fused.py:849-901, :992-1052, :662-705).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K7 _loop_train_kernel_T with a bf16 adjacency (hp false, launched by
//      _loop_train_impl) -> gnn_train_loop_bf16
//   K8 _loop_train_bwd_kernel with a bf16 adjacency (hp false, launched by
//      _loop_train_bwd_impl) -> gnn_train_loop_bwd_bf16
//   K6 _train_kernel_T with a bf16 adjacency (hp false, launched by
//      _train_fwd_impl) -> gnn_train_step_bf16
// The f32 K6 and K7 are in train_loop.cu, K8 in train_loop_bwd.cu. gnn_tpu's
// K6 backward on a bf16 batch is XLA in f32 on the upcast adjacency
// (_train_bwd_rule), not a kernel.
//
// One iteration on a block of W nodes, node-major, w = [Ws | Wa] [H, 2D],
// bf as in bf16.cuh, the keep-masks uint8 [.., W, D]:
//   agg = adjT^T @ bf(s) (+ rT)          over the sources ascending (saved)
//   x2  = [drop(s) | drop(agg)]          f32 (K6: the state slice arrives dropped)
//   h   = bf(x2) @ bf(w)^T + fT,  s' = act(h)
// and K8's reverse iteration k from s_in = s_{k} (s0 at k = 0) and the saved agg:
//   recompute h as the forward (no aggregation)
//   dh = (g_traj[k] + gs) * act'(h);  dfT[k] = dh;  dw += dh^T x2
//   dx2 = bf(dh) @ bf(w)
//   gs = dx2[:D] * dmask(ms) + adjT @ bf(dx2[D:] * dmask(ma))
// x2 enters dw unrounded (gnn_tpu's _BDT_HI). Every sum runs over its index
// ascending, one f32 add a term (products of bf values are exact, so fmaf
// adds them once rounded), the dw partials node by node with each product
// rounded, the elementwise steps as the plain versions take them (__fmul_rn,
// __fadd_rn), the activations through act64 / act_grad64: a launch gives the
// plain versions' bits (ops/fused.py::train_{loop,loop_bwd,step}_bf16_ref),
// the per-block dw partials included.
//
// Design (bf16.cuh's, simple, not yet tuned): one CTA of 256 threads a block,
// the bf16 adjacency staged in shared memory once a launch (2*W*W bytes,
// 32 KiB at W = 128; K7 and K8 keep it for all K iterations), beside rows
// [W][D] (K7 the state and its successor, K8 gs and dh, K6 the state) and
// bf(x2) [W][2D] (K8 also x2 unrounded, and dx2 in bf(x2)'s place once h is
// taken). A thread takes an output entry at a time. K8's dw partials are the
// block's slice of the output, which the wrapper zeroes and each thread adds
// its own entries to. No atomics: a repeat launch is bit-identical.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block), the f32 rows
// (s0, fT, the masks; K8 the trajectory, aggregations and cotangents) once,
// the outputs written once; the operations 2*D an arc and 2*H*2D a node an
// iteration (K8: 2*D*2D a node for h, 2*2D*D for dx2 and 2*D an arc for ds
// in bf16, 2*D*2D a node for dw in fp32) at the dense bf16 tensor-core rate
// (chip_smoke.py::bf16_bounds). The CUDA-core FMAs over the dense staged
// adjacency run far from it; tensor-core tiles are a later redesign's.
//
// Margins (K7): margins[k] = nm where the node moved before iteration k,
// ||s_k - s_{k-1}|| > thr * ||s_{k-1}||, s_{-1} = 1.

#include "bf16.cuh"

namespace {

using namespace gnn;

// The shared-memory regions (train_bf16_smem; ops/fused2.py::
// bf16_smem_bytes): the adjacency [W][W], `rows` rows [W][D] (r0, r1), in
// K8 x2 [W][2D], then bf(x2) [W][2D].
struct TrainSmem {
  uint16_t* adj;
  float* r0;
  float* r1;
  float* x2;
  float* xb;
};

// K7: 2 rows and bf(x2); K8: 2 rows, x2 and bf(x2); K6: 1 row and bf(x2).
inline size_t train_bf16_smem(int W, int D, int rows, int wide) {
  return 2 * (size_t)W * W + 4 * (size_t)W * (rows * D + wide * 2 * D);
}

__device__ TrainSmem train_layout(void* base, int W, int D, int rows, int wide) {
  TrainSmem m;
  m.adj = static_cast<uint16_t*>(base);
  float* f = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  m.r0 = f;
  m.r1 = rows > 1 ? f + W * D : nullptr;
  f += rows * W * D;
  m.x2 = wide > 1 ? f : nullptr;
  m.xb = wide > 1 ? f + 2 * W * D : f;
  return m;
}

// Stage block b's bf16 adjacency (16-byte copies: 2*W*W is a multiple of 16).
__device__ void stage_adj(const TrainSmem& m, const uint16_t* __restrict__ adjT, int b, int W) {
  const int4* src = reinterpret_cast<const int4*>(adjT + (size_t)b * W * W);
  int4* dst = reinterpret_cast<int4*>(m.adj);
  for (int i = threadIdx.x; i < W * W / 8; i += blockDim.x) dst[i] = src[i];
}

// x2 into m.xb rounded (and m.x2 unrounded where the layout has it), the
// block's rows starting at node `row` of the masks' and aggregations'
// [.., W, D] layout: the state slice from `xs` (block rows, shared or
// device memory), dropped with ms where `drop_s` (K6's arrives dropped); the
// aggregated slice from agg_in (the reverse) or computed from the state rows
// `s` in shared memory, agg = adjT^T @ bf(s) (+ rT), and written to agg_out.
__device__ void build_x2(const TrainSmem& m, const float* xs, bool drop_s, const float* s,
                         const float* __restrict__ rT, const float* __restrict__ agg_in,
                         float* __restrict__ agg_out, const uint8_t* __restrict__ ms,
                         const uint8_t* __restrict__ ma, size_t row, int W, int D, int mode,
                         float da, float db) {
  const int C = 2 * D;
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int n = i / D, d = i % D;
    const size_t at = row * D + i;
    float a;
    if (agg_in != nullptr) {
      a = agg_in[at];
    } else {
      a = 0.0f;
      for (int src = 0; src < W; ++src)
        a = fmaf(bf16_value(m.adj[src * W + n]), bf(s[src * D + d]), a);
      if (rT != nullptr) a = __fadd_rn(a, __ldg(rT + at));
      agg_out[at] = a;
    }
    const float x = drop_s ? drop_rn(mode, da, db, xs[i], ms, at) : xs[i];
    const float y = drop_rn(mode, da, db, a, ma, at);
    m.xb[n * C + d] = bf(x);
    m.xb[n * C + D + d] = bf(y);
    if (m.x2 != nullptr) {
      m.x2[n * C + d] = x;
      m.x2[n * C + D + d] = y;
    }
  }
}

// h of node n, unit h: bf(x2) . bf(w[h]) over the columns ascending, + f.
__device__ __forceinline__ float h_of(const TrainSmem& m, const float* __restrict__ w, float f,
                                      int n, int h, int C) {
  const float* wr = w + (size_t)h * C;
  const float* x = m.xb + n * C;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) acc = fmaf(x[c], bf(__ldg(wr + c)), acc);
  return __fadd_rn(acc, f);
}

// margins of block b before the next iteration: s_old in `old` (null: ones)
__device__ void margins(const float* s, const float* old, const float* __restrict__ nm,
                        float* marg, int b, int W, int D, float thr) {
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    float dist = 0.0f, norm = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float o = old == nullptr ? 1.0f : old[n * D + d], e = s[n * D + d] - o;
      dist += e * e;
      norm += o * o;
    }
    marg[n] = sqrtf(dist) > thr * sqrtf(norm) ? nm[(size_t)b * W + n] : 0.0f;
  }
}

__global__ void __launch_bounds__(kBf16Threads)
train_loop_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                       const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                       const float* __restrict__ fT, const float* __restrict__ w,
                       const float* __restrict__ nm, float* __restrict__ traj,
                       float* __restrict__ marg, float* __restrict__ agg, int B, int W, int D,
                       int K, float thr, int act, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int WD = W * D;
  const TrainSmem m = train_layout(smem_f4, W, D, 2, 1);
  const int b = blockIdx.x;
  float* s = m.r0;
  float* next = m.r1;
  stage_adj(m, adjT, b, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) s[i] = s0[(size_t)b * WD + i];
  __syncthreads();
  margins(s, nullptr, nm, marg + (size_t)b * W, b, W, D, thr);
  for (int k = 0; k < K; ++k) {
    const size_t row = ((size_t)k * B + b) * W;
    build_x2(m, s, true, s, nullptr, nullptr, agg, ms, ma, row, W, D, mode, da, db);
    __syncthreads();
    float* out = traj + row * D;
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const float v = act64(act, h_of(m, w, __ldg(fT + row * D + i), i / D, i % D, 2 * D));
      next[i] = v;
      out[i] = v;
    }
    __syncthreads();
    if (k + 1 < K) margins(next, s, nm, marg + ((size_t)(k + 1) * B + b) * W, b, W, D, thr);
    __syncthreads();
    for (int i = threadIdx.x; i < WD; i += blockDim.x) s[i] = next[i];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBf16Threads)
train_loop_bwd_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                           const float* __restrict__ traj, const float* __restrict__ agg,
                           const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                           const float* __restrict__ fT, const float* __restrict__ w,
                           const float* __restrict__ g_traj, float* __restrict__ gs_out,
                           float* __restrict__ dw, float* __restrict__ dfT, int B, int W, int D,
                           int K, int act, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int WD = W * D, C = 2 * D;
  const TrainSmem m = train_layout(smem_f4, W, D, 2, 2);
  const int b = blockIdx.x;
  float* gs = m.r0;
  float* dh = m.r1;    // dh, then bf(dagg)
  float* dx2 = m.xb;   // once h is taken
  float* dw_b = dw + (size_t)b * D * C;
  stage_adj(m, adjT, b, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) gs[i] = 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    const float* s_in = (k ? traj + (size_t)(k - 1) * B * WD : s0) + (size_t)b * WD;
    const size_t row = ((size_t)k * B + b) * W;
    __syncthreads();  // the last iteration's gs, bf(dagg) and dx2 reads are done
    build_x2(m, s_in, true, nullptr, nullptr, agg, nullptr, ms, ma, row, W, D, mode, da, db);
    __syncthreads();
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const float h = h_of(m, w, __ldg(fT + row * D + i), i / D, i % D, C);
      const float v = __fmul_rn(__fadd_rn(__ldg(g_traj + row * D + i), gs[i]),
                                act_grad64(act, h));
      dh[i] = v;
      dfT[row * D + i] = v;
    }
    __syncthreads();
    // dw += dh^T x2 node by node; dx2 = bf(dh) @ bf(w), the units ascending
    for (int i = threadIdx.x; i < D * C; i += blockDim.x) {
      const int h = i / C, c = i % C;
      float acc = 0.0f;
      for (int n = 0; n < W; ++n)
        acc = __fadd_rn(acc, __fmul_rn(dh[n * D + h], m.x2[n * C + c]));
      dw_b[i] = __fadd_rn(dw_b[i], acc);
    }
    for (int i = threadIdx.x; i < W * C; i += blockDim.x) {
      const int n = i / C, c = i % C;
      float acc = 0.0f;
      for (int h = 0; h < D; ++h)
        acc = fmaf(bf(dh[n * D + h]), bf(__ldg(w + (size_t)h * C + c)), acc);
      dx2[i] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const int n = i / D, d = i % D;
      dh[i] = bf(dmask_rn(mode, da, dx2[n * C + D + d], ma, row * D + i));
    }
    __syncthreads();
    // gs = dx2[:D] * dmask(ms) + adjT @ bf(dagg), the destinations ascending
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const int src = i / D, d = i % D;
      float acc = 0.0f;
      for (int dst = 0; dst < W; ++dst)
        acc = fmaf(bf16_value(m.adj[src * W + dst]), dh[dst * D + d], acc);
      gs[i] = __fadd_rn(dmask_rn(mode, da, dx2[src * C + d], ms, row * D + i), acc);
    }
  }
  __syncthreads();
  float* o = gs_out + (size_t)b * WD;
  for (int i = threadIdx.x; i < WD; i += blockDim.x) o[i] = gs[i];
}

__global__ void __launch_bounds__(kBf16Threads)
train_step_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s,
                       const float* __restrict__ sd, const uint8_t* __restrict__ keep,
                       const float* __restrict__ rT, const float* __restrict__ fT,
                       const float* __restrict__ w, float* __restrict__ y,
                       float* __restrict__ agg, int W, int D, int H, int act, int mode,
                       float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int WD = W * D;
  const TrainSmem m = train_layout(smem_f4, W, D, 1, 1);
  const int b = blockIdx.x;
  const size_t row = (size_t)b * W;
  stage_adj(m, adjT, b, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) m.r0[i] = s[(size_t)b * WD + i];
  __syncthreads();
  build_x2(m, sd + (size_t)b * WD, false, m.r0, rT, nullptr, agg, nullptr, keep, row, W, D,
           mode, da, db);
  __syncthreads();
  const size_t o = row * H;
  for (int i = threadIdx.x; i < W * H; i += blockDim.x)
    y[o + i] = act64(act, h_of(m, w, __ldg(fT + o + i), i / H, i % H, 2 * D));
}

bool drop_ok(int mode, const uint8_t* a, const uint8_t* b) {
  return mode == kNoDrop || (a != nullptr && b != nullptr);
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 [B, W, D], ms, ma uint8 [K, B, W, D] (null without
// dropout), fT [K, B, W, D], w [D, 2D], nm [B, W] -> traj [K, B, W, D], marg
// [K, B, W], agg [K, B, W, D]. Returns a cudaError_t code.
int gnn_train_loop_bf16(const uint16_t* adjT, const float* s0, const uint8_t* ms,
                        const uint8_t* ma, const float* fT, const float* w, const float* nm,
                        float* traj, float* marg, float* agg, int B, int W, int D, int K,
                        float thr, int act, int mode, float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || !drop_ok(mode, ms, ma))
    return cudaErrorInvalidValue;
  const size_t bytes = train_bf16_smem(W, D, 2, 1);
  cudaError_t err = set_smem(train_loop_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  train_loop_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, ms, ma, fT, w, nm, traj, marg, agg, B, W, D, K, thr, act, mode, da, db);
  return cudaGetLastError();
}

// As gnn_train_loop_bf16's, traj, agg and g_traj [K, B, W, D] -> gs
// [B, W, D], dfT [K, B, W, D]; dw [B, D, 2D] accumulated into an output the
// caller zeroed. Returns a cudaError_t code.
int gnn_train_loop_bwd_bf16(const uint16_t* adjT, const float* s0, const float* traj,
                            const float* agg, const uint8_t* ms, const uint8_t* ma,
                            const float* fT, const float* w, const float* g_traj, float* gs,
                            float* dw, float* dfT, int B, int W, int D, int K, int act, int mode,
                            float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || !drop_ok(mode, ms, ma))
    return cudaErrorInvalidValue;
  const size_t bytes = train_bf16_smem(W, D, 2, 2);
  cudaError_t err = set_smem(train_loop_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  train_loop_bwd_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, agg, ms, ma, fT, w, g_traj, gs, dw, dfT, B, W, D, K, act, mode, da, db);
  return cudaGetLastError();
}

// adjT bf16 [B, W, W], s and sd [B, W, D], keep uint8 [B, W, D] (null without
// dropout), rT [B, W, D] (nullable), fT [B, W, H], w [H, 2D] -> y [B, W, H],
// agg [B, W, D]. Returns a cudaError_t code.
int gnn_train_step_bf16(const uint16_t* adjT, const float* s, const float* sd,
                        const uint8_t* keep, const float* rT, const float* fT, const float* w,
                        float* y, float* agg, int B, int W, int D, int H, int act, int mode,
                        float da, float db, void* stream) {
  if (!block_ok(B, W) || D <= 0 || H <= 0 || !drop_ok(mode, keep, keep))
    return cudaErrorInvalidValue;
  const size_t bytes = train_bf16_smem(W, D, 1, 1);
  cudaError_t err = set_smem(train_step_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  train_step_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s, sd, keep, rT, fT, w, y, agg, W, D, H, act, mode, da, db);
  return cudaGetLastError();
}

}  // extern "C"
