// K3, the eval loop of the GNN fixed-point iteration (the flagship's
// one-layer state net), for Hopper (sm_90a), in plain fp32 on the CUDA cores
// (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K3 _loop_kernel_T (launched by _fused_loop_impl) -> gnn_propagation_loop
// Its reverse, K5, is in eval_loop_bwd.cu; K4, one iteration of the
// residual-coupled blocks, in fused_eval.cu.
//
// All K iterations of a residual-free W-node block (the state width stays D),
// node-major rows; iteration k on the state s (traj[k - 1], or s0):
//   marg[k] = nm where ||s - s_old|| > thr ||s_old|| (s_old: the state before
//             s, ones at k = 0), else 0
//   U       = s @ [Ws; Wa]^T              [W, 2D]
//   A[dst]  = sum_src adjT[src, dst] * U[src, D:]
//   traj[k] = act((U[:, :D] + A) + fT) * scale + shift
// with fT = feats @ Wf^T + b hoisted out of the loop and (scale, shift) the
// inference BatchNorm.
//
// Bound: a launch reads each block's adjacency (4*W*W bytes, 64 KiB at
// W = 128) once and writes K trajectories (4*D bytes a node and iteration);
// the arcs present need 2*D flops each and the dense layer 4*D*D a node and
// iteration, so the least time is set by the bytes (chip_smoke.py: 0.0511 ms
// on the serving batch's 1440 loop rows, K = 5).
//
// Design (K1's staging and column lists, bn_fwd.cu), one CTA of NT threads a
// block row:
// - no resident adjacency: each column's nonzero entries go into a compact
//   list ([16][W] weights and uint8 sources, tile2.cuh::build_col_lists, from
//   coalesced 16-byte reads of device memory) once a launch, in source order,
//   and all K iterations aggregate over it: 2*D an arc, not the dense W*W
//   contraction. A column of more than 16 entries is read from device memory,
//   every entry, so a dense block is exact;
// - every operand (w2 transposed, the affine, nm, s0 and fT) is staged with
//   cp.async, issued together ahead of the list build and waited on once;
// - U on NT / W threads a node, each taking a block of the 2D outputs, four
//   at a time from 16-byte reads of the transposed w2, each a chain over d
//   from 0 (the per-node kernel's order); U is kept node-major [W][2D | 1];
// - the movement test one thread a node, d ascending, with the per-node
//   kernel's rounding (__fadd_rn, __fmul_rn);
// - s' for each (node, column), (U[:, :D] + A) + fT with A over src
//   ascending, as the per-node kernel associated it, written into the state
//   buffer s_old leaves free and to traj[k] by coalesced writes (consecutive
//   threads, consecutive (node, column) pairs). Two barriers an iteration.
// No atomics: a repeat launch is bit-identical, every plan gives the same
// bits, and traj and marg are bit for bit the per-node K3's (K5 reads that
// trajectory on the clean training route).
// At the flagship's widths (W 128, D 14) a CTA of plan 0 takes 50,448 bytes,
// and the launch bounds hold a thread to 64 registers, so four CTAs (32
// warps) fit an SM: on an NVIDIA H100 0.164 ms of device time against three
// CTAs' 0.181 on the serving batch's 1440 loop rows, the same bits
// (PERF.md §6). The plans (kLoopPlans: threads a CTA, list room; mirrored by
// ops/fused.py::_LOOP_PLANS): the first (256 threads, the lists) fits every
// shape the kernel takes; the leanest (128 threads, no lists) too.

#include "tile2.cuh"

namespace {

using namespace gnn;

// A K3 plan: threads a CTA, room of the column lists (0: the adjacency is
// read from device memory).
struct LoopPlan {
  int nt, E;
};

constexpr LoopPlan kLoopPlans[] = {{256, 16}, {128, 0}};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K3's shared memory (bytes for the list counts and
// sources, after the floats), each region a multiple of 16 bytes: U
// [W][2D | 1] (node-major; the list build's counts [NT / 32][W], as bytes,
// before the first iteration), two state buffers [W][D | 1] (s, then each
// iteration's s' into the one s_old leaves), fT [W][D | 1], w2 transposed
// w2T [D][J4] (J4 = 2D rounded up to 4, zero past 2D), the affine [2][D],
// nm [W], the lists [E][W].
struct LoopLayout {
  int u, s0, s1, f, w, aff, nm, lw;
  size_t cnt_b, idx_b, bytes;
};

__host__ __device__ inline LoopLayout loop_layout(int W, int D, const LoopPlan& p) {
  LoopLayout L{};
  int o = 0;
  L.u = o;
  o += round4(W * ((2 * D) | 1));
  L.s0 = o;
  o += round4(W * (D | 1));
  L.s1 = o;
  o += round4(W * (D | 1));
  L.f = o;
  o += round4(W * (D | 1));
  L.w = o;
  o += D * round4(2 * D);
  L.aff = o;
  o += round4(2 * D);
  L.nm = o;
  o += round4(W);
  L.lw = o;
  o += p.E * W;
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + (p.E ? W : 0);
  L.bytes = L.idx_b + (size_t)p.E * W;
  return L;
}

// K3: all K iterations over every block row, NT threads a CTA, one block row
// each.
template <int NT>
__global__ void __launch_bounds__(NT, 4)
loop_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
            const float* __restrict__ fT, const float* __restrict__ w2,
            const float* __restrict__ aff, const float* __restrict__ nm,
            float* __restrict__ traj, float* __restrict__ marg, int B, int W, int D, int K,
            float thr, int act, LoopPlan p) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const LoopLayout L = loop_layout(W, D, p);
  const int DP = D | 1, UP = (2 * D) | 1, J4 = round4(2 * D);
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  float* U = sm + L.u;
  float* cur = sm + L.s0;  // s
  float* old = sm + L.s1;  // s_old, then s'
  float* F = sm + L.f;
  float* wT = sm + L.w;
  float* af = sm + L.aff;  // [scale; shift] x [D]
  float* nms = sm + L.nm;
  float* lw = sm + L.lw;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;

  // ---- staging, issued together, waited on once
  // wT [d][j] = w2 [j][d], in w2's order (whole rows of it a warp)
  for (int i = t; i < J4 * D; i += NT) {
    const int j = i / D, d = i % D;
    if (j < 2 * D)
      cp_async4(wT + d * J4 + j, w2 + i);
    else
      wT[d * J4 + j] = 0.0f;
  }
  for (int i = t; i < 2 * D; i += NT) cp_async4(af + i, aff + i);
  cp_rows(nms, nm + row0, W);
  for (int i = t; i < W * D; i += NT) {
    const int o = (i / D) * DP + i % D;
    cp_async4(cur + o, s0 + row0 * D + i);
    cp_async4(F + o, fT + row0 * D + i);
  }
  if (p.E > 0) build_col_lists(adj, W, p.E, lw, idx, cnt, reinterpret_cast<uint8_t*>(U));
  cp_async_wait_all();
  __syncthreads();

  // U's outputs [j0, j1) of node n are thread t's
  const int tpn = NT / W, n = t % W, part = t / W;
  const int JB = round4((2 * D + tpn - 1) / tpn), j0 = part * JB, j1 = min(2 * D, j0 + JB);
  for (int k = 0; k < K; ++k) {
    // ---- the movement test before update k, one thread a node, d ascending
    for (int m = t; m < W; m += NT) {
      float dist2 = 0.0f, norm2 = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float s = cur[m * DP + d], so = k > 0 ? old[m * DP + d] : 1.0f;
        const float diff = __fsub_rn(s, so);
        dist2 = __fadd_rn(dist2, __fmul_rn(diff, diff));
        norm2 = __fadd_rn(norm2, __fmul_rn(so, so));
      }
      marg[(size_t)k * B * W + row0 + m] = sqrtf(dist2) > thr * sqrtf(norm2) ? nms[m] : 0.0f;
    }

    // ---- U = s @ w2^T, four outputs a 16-byte read of wT, each a chain over
    // d from 0
    if (part < tpn)
      for (int q = j0; q < j1; q += 4) {
        float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = 0; d < D; ++d) {
          const float x = cur[n * DP + d];
          float w4[4];
          ldv<4>(wT + d * J4 + q, w4);
#pragma unroll
          for (int v = 0; v < 4; ++v) u[v] = fmaf(w4[v], x, u[v]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (q + v < j1) U[n * UP + q + v] = u[v];
      }
    __syncthreads();  // U is full; s_old is read

    // ---- A = adjT^T @ U[:, D:] over the column lists (src ascending), s'
    // into the buffer s_old leaves and out to traj[k], node-major
    float* out = traj + ((size_t)k * B + b) * W * D;
    for (int i = t; i < W * D; i += NT) {
      const int m = i / D, h = i % D;
      const float* ua = U + D + h;
      float a = 0.0f;
      const int c = p.E > 0 ? cnt[m] : W + 1;
      if (c <= p.E) {
        for (int e = 0; e < c; ++e) a = fmaf(lw[e * W + m], ua[idx[e * W + m] * UP], a);
      } else {
        for (int src = 0; src < W; ++src) a = fmaf(adj[(size_t)src * W + m], ua[src * UP], a);
      }
      const float y = activate(act, (U[m * UP + h] + a) + F[m * DP + h]) * af[h] + af[D + h];
      old[m * DP + h] = y;
      out[i] = y;
    }
    __syncthreads();  // s' is full; U is read
    float* next = old;
    old = cur;
    cur = next;
  }
}

int g_force = -1;  // gnn_propagation_loop_force_plan

using LoopFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int, int, float, int, LoopPlan);

// K3's kernel and plan for a shape: the first plan of kLoopPlans that fits a
// CTA, or plan g_force (>= 0) if it fits; nullptr (bytes: the last plan's)
// if none.
LoopFn pick_loop(int W, int D, LoopPlan* p, size_t* bytes, int* index) {
  constexpr int N = sizeof(kLoopPlans) / sizeof(kLoopPlans[0]);
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i < N; ++i) {
    *bytes = loop_layout(W, D, kLoopPlans[i]).bytes;
    if (*bytes <= (size_t)kMaxSmemBytes) {
      *p = kLoopPlans[i];
      *index = i;
      break;
    }
    if (g_force >= 0) break;
  }
  if (*index < 0) return nullptr;
  return p->nt == 256 ? loop_kernel<256> : loop_kernel<128>;
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0/fT [B, W, D], w2 [2D, D], aff [2, D], nm [B, W]
// -> traj [K, B, W, D], marg [K, B, W]. Returns a cudaError_t code.
int gnn_propagation_loop(const float* adjT, const float* s0, const float* fT, const float* w2,
                         const float* aff, const float* nm, float* traj, float* marg, int B,
                         int W, int D, int K, float thr, int act, void* stream) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || width_class(D) == 0) return cudaErrorInvalidValue;
  LoopPlan p;
  size_t bytes;
  int index;
  const LoopFn fn = pick_loop(W, D, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(adjT, s0, fT, w2, aff, nm, traj, marg,
                                                            B, W, D, K, thr, act, p);
  return cudaGetLastError();
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_loop launches
// for this shape (AL and H1 unused). Returns a cudaError_t code.
int gnn_propagation_loop_info(int W, int D, int AL, int H1, int* out) {
  (void)AL;
  (void)H1;
  LoopPlan p;
  size_t bytes;
  int index;
  const LoopFn fn = pick_loop(W, D, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` of kLoopPlans from now on, where it fits (a launch at a
// shape it does not fit fails), or the first plan that fits again (index
// -1): for timing one plan against another.
void gnn_propagation_loop_force_plan(int index) { g_force = index; }

}  // extern "C"
