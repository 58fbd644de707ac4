// K12_bf16 and K13_bf16, the two-layer dropout-training loop on a bf16 block
// adjacency and its reverse, for Hopper (sm_90a): gnn_tpu's `hp = False`
// branch of _loop2_train_kernel_T and _loop2_train_bwd_kernel
// (pallas_fused.py:1551-1598, :1696-1758), all K iterations of residual-free
// blocks in one launch each.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K12 _loop2_train_kernel_T with a bf16 adjacency (hp false, launched by
//       _loop2_train_impl) -> gnn_train_loop2_bf16
//   K13 _loop2_train_bwd_kernel with a bf16 adjacency (hp false, launched by
//       _loop2_train_bwd_impl) -> gnn_train_loop2_bwd_bf16
// The f32 K12 is in loop2.cu, K13 in train_loop2_bwd.cu.
//
// One iteration k on a block of W nodes, node-major, x3 the dense input of
// C = 2D + AL columns, bf as in bf16.cuh, the masks ms, ma uint8 [K, B, W, D]:
//   agg = adjT^T @ bf(s)                        over the sources ascending (saved)
//   x3  = [drop(s) | drop(agg) | fd_k]          f32
//   h0  = bf(x3) @ bf(w0)^T + b0,  y0 = act0(h0)
//   h1  = bf(y0) @ bf(w1)^T + b1,  s' = act1(h1)
// and reverse iteration k from s_in = s_{k} (s0 at k = 0) and the saved agg:
//   recompute h0, y0 and h1 as the forward (no aggregation)
//   dh1 = (g_traj[k] + gs) * act1'(h1);  db1 += sum dh1;  dw1 += dh1^T y0
//   dh0 = (bf(dh1) @ bf(w1)) * act0'(h0); db0 += sum dh0;  dw0 += dh0^T x3
//   dx3 = bf(dh0) @ bf(w0);  dfd[k] = dx3[2D:]
//   dagg = dx3[D:2D] * dmask(ma);  gs = dx3[:D] * dmask(ms) + adjT @ bf(dagg)
// y0 and x3 enter dw1 and dw0 unrounded (gnn_tpu's _BDT_HI). Every sum runs
// over its index ascending, one f32 add a term (products of bf values are
// exact, so fmaf adds them once rounded), the weight partials node by node
// with each product rounded, the elementwise steps as the plain versions
// take them (__fmul_rn, __fadd_rn), the activations through act64 /
// act_grad64: a launch gives the plain versions' bits
// (ops/fused2.py::train_loop2{,_bwd}_bf16_ref), the per-block partials
// included.
//
// Design (bf16.cuh's, simple, not yet tuned): one CTA of 256 threads a block,
// the bf16 adjacency staged in shared memory once a launch (2*W*W bytes,
// 32 KiB at W = 128) for all K iterations, beside two rows [W][D] and
// bf(x3) [W][C] (the reverse: also x3 and dx3 [W][C]); the hidden units in
// chunks of kBf16Chunk. The forward takes a chunk's bf(y0), then its terms of
// h1; the reverse runs the chunks twice an iteration: for h1 (its terms need
// every chunk), then for h0, y0, dh0 and the chunk's terms of db0, dw1, dw0
// and dx3. The weight partials are the block's slices of the outputs, which
// the wrapper zeroes and each thread adds its own entries to. No atomics: a
// repeat launch is bit-identical.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block), the f32 rows
// (s0, fd, the masks; K13 the trajectory, aggregations and cotangents) once,
// the outputs written once; the operations 2*D an arc and 2*(H1*C + D*H1) a
// node an iteration (K13 the forward and its reverse: 2*D an arc and
// 2*(2*H1*C + 3*D*H1) a node, fp32 for dw0 and dw1) at the dense bf16
// tensor-core rate (chip_smoke.py::bf16_bounds). The CUDA-core FMAs over the
// dense staged adjacency run far from it; tensor-core tiles are a later
// redesign's.
//
// Margins (K12): margins[k] = nm where the node moved before iteration k,
// ||s_k - s_{k-1}|| > thr * ||s_{k-1}||, s_{-1} = 1.

#include "bf16.cuh"

namespace {

using namespace gnn;

constexpr int CH = kBf16Chunk;

// The shared-memory regions (train2_bf16_smem; ops/fused2.py::
// bf16_smem_bytes): the adjacency [W][W], rows r0, r1 [W][D], bf(x3) [W][C],
// in the reverse x3 and dx3 [W][C], then the chunks c0 (the reverse: c1, c2)
// [W][CH].
struct Train2Smem {
  uint16_t* adj;
  float* r0;
  float* r1;
  float* xb;
  float* x3;
  float* dx3;
  float* c0;
  float* c1;
  float* c2;
};

inline size_t train2_bf16_smem(int W, int D, int C, bool reverse) {
  const size_t wide = reverse ? 3 : 1;
  return 2 * (size_t)W * W + 4 * (size_t)W * (2 * D + wide * C + wide * CH);
}

__device__ Train2Smem train2_layout(void* base, int W, int D, int C, bool reverse) {
  Train2Smem m;
  m.adj = static_cast<uint16_t*>(base);
  float* f = reinterpret_cast<float*>(m.adj + (size_t)W * W);
  m.r0 = f;
  m.r1 = f + W * D;
  m.xb = f + 2 * W * D;
  f += 2 * W * D + W * C;
  m.x3 = reverse ? f : nullptr;
  m.dx3 = reverse ? f + W * C : nullptr;
  f += reverse ? 2 * W * C : 0;
  m.c0 = f;
  m.c1 = reverse ? f + W * CH : nullptr;
  m.c2 = reverse ? f + 2 * W * CH : nullptr;
  return m;
}

// Stage block b's bf16 adjacency (16-byte copies: 2*W*W is a multiple of 16).
__device__ void stage_adj(const Train2Smem& m, const uint16_t* __restrict__ adjT, int b,
                          int W) {
  const int4* src = reinterpret_cast<const int4*>(adjT + (size_t)b * W * W);
  int4* dst = reinterpret_cast<int4*>(m.adj);
  for (int i = threadIdx.x; i < W * W / 8; i += blockDim.x) dst[i] = src[i];
}

// x3 of iteration k into m.xb rounded (and m.x3 unrounded in the reverse):
// the state slice from `s` (block rows [W][D], shared or device memory), the
// aggregated slice computed from m.r0 (the forward: agg = adjT^T @ bf(s),
// also written to agg_out) or read from agg_in (the reverse), fd_k.
__device__ void build_x3(const Train2Smem& m, const float* s, const float* __restrict__ agg_in,
                         float* __restrict__ agg_out, const float* __restrict__ fd,
                         const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma, int k,
                         int b, int B, int W, int D, int AL, int mode, float da, float db) {
  const int C = 2 * D + AL;
  const size_t row = ((size_t)k * B + b) * W;   // iteration k's block rows
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int n = i / D, d = i % D;
    float a;
    if (agg_in != nullptr) {
      a = agg_in[row * D + i];
    } else {
      a = 0.0f;
      for (int src = 0; src < W; ++src)
        a = fmaf(bf16_value(m.adj[src * W + n]), bf(m.r0[src * D + d]), a);
      agg_out[row * D + i] = a;
    }
    const float xs = drop_rn(mode, da, db, s[i], ms, row * D + i);
    const float xa = drop_rn(mode, da, db, a, ma, row * D + i);
    m.xb[n * C + d] = bf(xs);
    m.xb[n * C + D + d] = bf(xa);
    if (m.x3 != nullptr) {
      m.x3[n * C + d] = xs;
      m.x3[n * C + D + d] = xa;
    }
  }
  for (int i = threadIdx.x; i < W * AL; i += blockDim.x) {
    const int n = i / AL, f = i % AL;
    const float v = __ldg(fd + row * AL + i);
    m.xb[n * C + 2 * D + f] = bf(v);
    if (m.x3 != nullptr) m.x3[n * C + 2 * D + f] = v;
  }
}

// h0 of node n, hidden unit h: bf(x3) . bf(w0[h]) over the columns ascending, + b0.
__device__ __forceinline__ float h0_of(const Train2Smem& m, const float* __restrict__ w0,
                                       const float* __restrict__ b0, int n, int h, int C) {
  const float* w = w0 + (size_t)h * C;
  const float* x = m.xb + n * C;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) acc = fmaf(x[c], bf(__ldg(w + c)), acc);
  return __fadd_rn(acc, __ldg(b0 + h));
}

// h1 (in `h1`, zeroed by the caller), before its bias: every chunk's bf(y0)
// into c0, then its terms bf(y0) * bf(w1), the units ascending.
__device__ void forward_h1(const Train2Smem& m, float* h1, const float* __restrict__ w0,
                           const float* __restrict__ b0, const float* __restrict__ w1, int W,
                           int D, int C, int H1, int act0) {
  for (int h0 = 0; h0 < H1; h0 += CH) {
    const int cw = min(CH, H1 - h0);
    __syncthreads();  // x3 and h1 ready; the last chunk's terms read c0
    for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
      const int n = i / cw, h = i % cw;
      m.c0[n * CH + h] = bf(act64(act0, h0_of(m, w0, b0, n, h0 + h, C)));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
      const int n = i / D, d = i % D;
      const float* w = w1 + (size_t)d * H1 + h0;
      float acc = h1[i];
      for (int h = 0; h < cw; ++h) acc = fmaf(m.c0[n * CH + h], bf(__ldg(w + h)), acc);
      h1[i] = acc;
    }
  }
  __syncthreads();
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
train_loop2_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                        const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                        const float* __restrict__ fd, const float* __restrict__ w0,
                        const float* __restrict__ b0, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ nm,
                        float* __restrict__ traj, float* __restrict__ marg,
                        float* __restrict__ agg, int B, int W, int D, int AL, int H1, int K,
                        float thr, int act0, int act1, int mode, float da, float db) {
  extern __shared__ float4 smem_f4[];
  const int C = 2 * D + AL, WD = W * D;
  const Train2Smem m = train2_layout(smem_f4, W, D, C, false);
  const int b = blockIdx.x;
  float* s = m.r0;
  float* h1 = m.r1;
  stage_adj(m, adjT, b, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) s[i] = s0[(size_t)b * WD + i];
  __syncthreads();
  margins(s, nullptr, nm, marg + (size_t)b * W, b, W, D, thr);
  for (int k = 0; k < K; ++k) {
    build_x3(m, s, nullptr, agg, fd, ms, ma, k, b, B, W, D, AL, mode, da, db);
    for (int i = threadIdx.x; i < WD; i += blockDim.x) h1[i] = 0.0f;
    forward_h1(m, h1, w0, b0, w1, W, D, C, H1, act0);
    float* out = traj + ((size_t)k * B + b) * WD;
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const float v = act64(act1, __fadd_rn(h1[i], __ldg(b1 + i % D)));
      h1[i] = v;
      out[i] = v;
    }
    __syncthreads();
    if (k + 1 < K) margins(h1, s, nm, marg + ((size_t)(k + 1) * B + b) * W, b, W, D, thr);
    __syncthreads();
    for (int i = threadIdx.x; i < WD; i += blockDim.x) s[i] = h1[i];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBf16Threads)
train_loop2_bwd_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                            const float* __restrict__ traj, const float* __restrict__ agg,
                            const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                            const float* __restrict__ fd, const float* __restrict__ w0,
                            const float* __restrict__ b0, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ g_traj,
                            float* __restrict__ gs_out, float* __restrict__ dw0,
                            float* __restrict__ db0, float* __restrict__ dw1,
                            float* __restrict__ db1, float* __restrict__ dfd, int B, int W,
                            int D, int AL, int H1, int K, int act0, int act1, int mode, float da,
                            float db) {
  extern __shared__ float4 smem_f4[];
  const int C = 2 * D + AL, WD = W * D;
  const Train2Smem m = train2_layout(smem_f4, W, D, C, true);
  const int b = blockIdx.x;
  float* dh1 = m.r0;  // h1, then dh1, then bf(dagg)
  float* gs = m.r1;
  float* dw0_b = dw0 + (size_t)b * H1 * C;
  float* dw1_b = dw1 + (size_t)b * D * H1;
  stage_adj(m, adjT, b, W);
  for (int i = threadIdx.x; i < WD; i += blockDim.x) gs[i] = 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    const float* s_in = (k ? traj + (size_t)(k - 1) * B * WD : s0) + (size_t)b * WD;
    const size_t row = ((size_t)k * B + b) * W;
    __syncthreads();  // the last iteration's gs and bf(dagg) reads are done
    build_x3(m, s_in, agg, nullptr, fd, ms, ma, k, b, B, W, D, AL, mode, da, db);
    for (int i = threadIdx.x; i < WD; i += blockDim.x) dh1[i] = 0.0f;
    forward_h1(m, dh1, w0, b0, w1, W, D, C, H1, act0);
    // dh1 = (g_traj[k] + gs) * act1'(h1 + b1); db1 += its node sums
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const float h = __fadd_rn(dh1[i], __ldg(b1 + i % D));
      dh1[i] = __fmul_rn(__fadd_rn(__ldg(g_traj + row * D + i), gs[i]), act_grad64(act1, h));
    }
    for (int i = threadIdx.x; i < W * C; i += blockDim.x) m.dx3[i] = 0.0f;
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float sum = 0.0f;
      for (int n = 0; n < W; ++n) sum = __fadd_rn(sum, dh1[n * D + d]);
      db1[(size_t)b * D + d] += sum;
    }
    // ---- the chunks again: h0, y0, dh0 and their terms
    for (int h0 = 0; h0 < H1; h0 += CH) {
      const int cw = min(CH, H1 - h0);
      __syncthreads();  // the last chunk's terms read c1, c2
      for (int i = threadIdx.x; i < W * cw; i += blockDim.x) {
        const int n = i / cw, h = i % cw;
        const float hv = h0_of(m, w0, b0, n, h0 + h, C);
        float acc = 0.0f;
        for (int d = 0; d < D; ++d)
          acc = fmaf(bf(dh1[n * D + d]), bf(__ldg(w1 + (size_t)d * H1 + h0 + h)), acc);
        m.c1[n * CH + h] = act64(act0, hv);
        m.c2[n * CH + h] = __fmul_rn(acc, act_grad64(act0, hv));
      }
      __syncthreads();
      for (int h = threadIdx.x; h < cw; h += blockDim.x) {
        float sum = 0.0f;
        for (int n = 0; n < W; ++n) sum = __fadd_rn(sum, m.c2[n * CH + h]);
        db0[(size_t)b * H1 + h0 + h] += sum;
      }
      for (int i = threadIdx.x; i < D * cw; i += blockDim.x) {
        const int d = i / cw, h = i % cw;
        float acc = 0.0f;
        for (int n = 0; n < W; ++n)
          acc = __fadd_rn(acc, __fmul_rn(dh1[n * D + d], m.c1[n * CH + h]));
        dw1_b[(size_t)d * H1 + h0 + h] += acc;
      }
      for (int i = threadIdx.x; i < cw * C; i += blockDim.x) {
        const int h = i / C, c = i % C;
        float acc = 0.0f;
        for (int n = 0; n < W; ++n)
          acc = __fadd_rn(acc, __fmul_rn(m.c2[n * CH + h], m.x3[n * C + c]));
        dw0_b[(size_t)(h0 + h) * C + c] += acc;
      }
      for (int i = threadIdx.x; i < W * C; i += blockDim.x) {
        const int n = i / C, c = i % C;
        float acc = m.dx3[i];
        for (int h = 0; h < cw; ++h)
          acc = fmaf(bf(m.c2[n * CH + h]), bf(__ldg(w0 + (size_t)(h0 + h) * C + c)), acc);
        m.dx3[i] = acc;
      }
    }
    __syncthreads();
    // dfd[k]; bf(dagg) into r0; then gs = dx3_s * dmask(ms) + adjT @ bf(dagg)
    for (int i = threadIdx.x; i < W * AL; i += blockDim.x)
      dfd[row * AL + i] = m.dx3[(i / AL) * C + 2 * D + i % AL];
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const int n = i / D, d = i % D;
      dh1[i] = bf(dmask_rn(mode, da, m.dx3[n * C + D + d], ma, row * D + i));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < WD; i += blockDim.x) {
      const int src = i / D, d = i % D;
      float acc = 0.0f;
      for (int dst = 0; dst < W; ++dst)
        acc = fmaf(bf16_value(m.adj[src * W + dst]), dh1[dst * D + d], acc);
      gs[i] = __fadd_rn(dmask_rn(mode, da, m.dx3[src * C + d], ms, row * D + i), acc);
    }
  }
  __syncthreads();
  float* o = gs_out + (size_t)b * WD;
  for (int i = threadIdx.x; i < WD; i += blockDim.x) o[i] = gs[i];
}

bool train2_ok(int B, int W, int D, int AL, int H1, int K, int mode, const uint8_t* ms,
               const uint8_t* ma) {
  return block_ok(B, W) && D > 0 && AL >= 0 && H1 > 0 && K > 0 &&
         (mode == kNoDrop || (ms != nullptr && ma != nullptr));
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 [B, W, D], ms, ma uint8 [K, B, W, D] (null without
// dropout), fd [K, B, W, AL], w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D],
// nm [B, W] -> traj [K, B, W, D], marg [K, B, W], agg [K, B, W, D]. Returns
// a cudaError_t code.
int gnn_train_loop2_bf16(const uint16_t* adjT, const float* s0, const uint8_t* ms,
                         const uint8_t* ma, const float* fd, const float* w0, const float* b0,
                         const float* w1, const float* b1, const float* nm, float* traj,
                         float* marg, float* agg, int B, int W, int D, int AL, int H1, int K,
                         float thr, int act0, int act1, int mode, float da, float db,
                         void* stream) {
  if (!train2_ok(B, W, D, AL, H1, K, mode, ms, ma)) return cudaErrorInvalidValue;
  const size_t bytes = train2_bf16_smem(W, D, 2 * D + AL, false);
  cudaError_t err = set_smem(train_loop2_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  train_loop2_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, traj, marg, agg, B, W, D, AL, H1, K, thr, act0,
      act1, mode, da, db);
  return cudaGetLastError();
}

// As gnn_train_loop2_bf16's, traj, agg and g_traj [K, B, W, D] -> gs
// [B, W, D], dfd [K, B, W, AL]; dw0 [B, H1, 2D + AL], db0 [B, H1], dw1
// [B, D, H1] and db1 [B, D] accumulated into outputs the caller zeroed.
// Returns a cudaError_t code.
int gnn_train_loop2_bwd_bf16(const uint16_t* adjT, const float* s0, const float* traj,
                             const float* agg, const uint8_t* ms, const uint8_t* ma,
                             const float* fd, const float* w0, const float* b0, const float* w1,
                             const float* b1, const float* g_traj, float* gs, float* dw0,
                             float* db0, float* dw1, float* db1, float* dfd, int B, int W, int D,
                             int AL, int H1, int K, int act0, int act1, int mode, float da,
                             float db, void* stream) {
  if (!train2_ok(B, W, D, AL, H1, K, mode, ms, ma)) return cudaErrorInvalidValue;
  const size_t bytes = train2_bf16_smem(W, D, 2 * D + AL, true);
  cudaError_t err = set_smem(train_loop2_bwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  train_loop2_bwd_bf16_kernel<<<B, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, gs, dw0, db0, dw1, db1, dfd, B, W,
      D, AL, H1, K, act0, act1, mode, da, db);
  return cudaGetLastError();
}

}  // extern "C"
