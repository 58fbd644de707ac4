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
// (PERF.md §6). The staged plans (kLoopPlans: threads a CTA, list room;
// mirrored by ops/fused.py::_LOOP_PLANS): the first (256 threads, the lists)
// fits every shape up to D 64 at W 128; the leanest (128 threads, no lists)
// a little more.
//
// The wide plan (kLoopWide, index 2, mirrored by ops/fused.py::_loop_wide),
// chosen only where no staged plan fits, takes every D: shared memory holds
// only nm, the column lists and the list build's counts (11,904 bytes at
// W 128, whatever D is). The state s is read from s0 or traj[k - 1] and
// s_old from traj[k - 2] in device memory, where this CTA wrote them (plain
// loads after a barrier), and s' goes straight to traj[k]; U [W][2D | 1]
// lies in a device-memory workspace the wrapper allocates (a block's slice
// each, gnn_propagation_loop_workspace floats); w2, fT and the affine are
// read from device memory through the caches. The code is the staged plans'
// with those pointers, so every output is the same chain and a forced wide
// plan gives the staged plans' bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

// A K3 plan: threads a CTA, room of the column lists (0: the adjacency is
// read from device memory).
struct LoopPlan {
  int nt, E;
};

constexpr LoopPlan kLoopPlans[] = {{256, 16}, {128, 0}};
// the wide plan, after the staged ones
constexpr LoopPlan kLoopWide = {256, 16};
constexpr int kLoopWideIndex = sizeof(kLoopPlans) / sizeof(kLoopPlans[0]);

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K3's shared memory (bytes for the list counts and
// sources, after the floats), each region a multiple of 16 bytes: U
// [W][2D | 1] (node-major; the list build's counts [NT / 32][W], as bytes,
// before the first iteration), two state buffers [W][D | 1] (s, then each
// iteration's s' into the one s_old leaves), fT [W][D | 1], w2 transposed
// w2T [D][J4] (J4 = 2D rounded up to 4, zero past 2D), the affine [2][D],
// nm [W], the lists [E][W]. The wide plan: nm, the lists, then the counts,
// sources and the list build's counts [NT / 32][W] as bytes; U at float
// offset 0 of a block's workspace slice of ws floats.
struct LoopLayout {
  int u, s0, s1, f, w, aff, nm, lw, ws;
  size_t cnt_b, idx_b, part_b, bytes;
};

__host__ __device__ inline LoopLayout loop_layout(int W, int D, const LoopPlan& p, bool wide) {
  LoopLayout L{};
  int o = 0;
  if (wide) {
    L.u = 0;
    L.ws = round4(W * ((2 * D) | 1));
    L.s0 = L.s1 = L.f = L.w = L.aff = -1;
    L.nm = o;
    o += round4(W);
    L.lw = o;
    o += p.E * W;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.part_b = L.idx_b + (size_t)p.E * W;
    L.bytes = L.part_b + (size_t)(p.nt / 32) * W;
    return L;
  }
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
  L.part_b = 0;
  L.ws = 0;
  return L;
}

// K3: all K iterations over every block row, NT threads a CTA, one block row
// each; WIDE: the wide plan (ws its workspace).
template <int NT, bool WIDE>
__global__ void __launch_bounds__(NT, 4)
loop_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
            const float* __restrict__ fT, const float* __restrict__ w2,
            const float* __restrict__ aff, const float* __restrict__ nm,
            float* __restrict__ traj, float* __restrict__ marg, int B, int W, int D, int K,
            float thr, int act, LoopPlan p, float* ws) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const LoopLayout L = loop_layout(W, D, p, WIDE);
  // the state rows' stride: [W][D | 1] buffers, or (wide) s0 and traj
  const int DP = WIDE ? D : (D | 1), UP = (2 * D) | 1, J4 = round4(2 * D);
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  float* U = WIDE ? ws + (size_t)b * L.ws + L.u : sm + L.u;
  const float* cur = WIDE ? s0 + row0 * D : sm + L.s0;  // s
  const float* old = WIDE ? nullptr : sm + L.s1;        // s_old
  const float* F = WIDE ? fT + row0 * D : sm + L.f;
  const float* wT = sm + L.w;
  const float* af = WIDE ? aff : sm + L.aff;  // [scale; shift] x [D]
  float* nms = sm + L.nm;
  float* lw = sm + L.lw;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;

  // ---- staging, issued together, waited on once
  if constexpr (!WIDE) {
    // wT [d][j] = w2 [j][d], in w2's order (whole rows of it a warp)
    for (int i = t; i < J4 * D; i += NT) {
      const int j = i / D, d = i % D;
      if (j < 2 * D)
        cp_async4(sm + L.w + d * J4 + j, w2 + i);
      else
        sm[L.w + d * J4 + j] = 0.0f;
    }
    for (int i = t; i < 2 * D; i += NT) cp_async4(sm + L.aff + i, aff + i);
    for (int i = t; i < W * D; i += NT) {
      const int o = (i / D) * DP + i % D;
      cp_async4(sm + L.s0 + o, s0 + row0 * D + i);
      cp_async4(sm + L.f + o, fT + row0 * D + i);
    }
  }
  cp_rows(nms, nm + row0, W);
  if (p.E > 0)
    build_col_lists(adj, W, p.E, lw, idx, cnt,
                    WIDE ? bytes + L.part_b : reinterpret_cast<uint8_t*>(U));
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

    // ---- U = s @ w2^T, four outputs a 16-byte read of wT (wide: four rows
    // of w2), each a chain over d from 0
    if (part < tpn)
      for (int q = j0; q < j1; q += 4) {
        float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = 0; d < D; ++d) {
          const float x = cur[n * DP + d];
          float w4[4];
          if constexpr (WIDE) {
#pragma unroll
            for (int v = 0; v < 4; ++v) w4[v] = q + v < 2 * D ? w2[(size_t)(q + v) * D + d] : 0.0f;
          } else {
            ldv<4>(wT + d * J4 + q, w4);
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) u[v] = fmaf(w4[v], x, u[v]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (q + v < j1) U[n * UP + q + v] = u[v];
      }
    __syncthreads();  // U is full; s_old is read

    // ---- A = adjT^T @ U[:, D:] over the column lists (src ascending), s'
    // into the buffer s_old leaves (wide: traj[k] alone) and out to traj[k],
    // node-major
    float* out = traj + ((size_t)k * B + b) * W * D;
    float* nxt = WIDE ? out : const_cast<float*>(old);
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
      nxt[m * DP + h] = y;
      if (!WIDE) out[i] = y;
    }
    __syncthreads();  // s' is full; U is read
    old = cur;
    cur = nxt;
  }
}

int g_force = -1;  // gnn_propagation_loop_force_plan

using LoopFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int, int, float, int, LoopPlan,
                        float*);

// K3's kernel and plan for a shape: the first plan of kLoopPlans that fits a
// CTA, else the wide plan (index kLoopWideIndex), or plan g_force (>= 0) if
// it fits; nullptr (bytes: the last plan's) if none. *ws: the plan's
// workspace floats a block.
LoopFn pick_loop(int W, int D, LoopPlan* p, size_t* bytes, int* index, int* ws) {
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i <= kLoopWideIndex; ++i) {
    const bool wide = i == kLoopWideIndex;
    const LoopPlan plan = wide ? kLoopWide : kLoopPlans[i];
    const LoopLayout L = loop_layout(W, D, plan, wide);
    *bytes = L.bytes;
    if (L.bytes <= (size_t)kMaxSmemBytes) {
      *p = plan;
      *index = i;
      *ws = L.ws;
      break;
    }
    if (g_force >= 0) break;
  }
  if (*index < 0) return nullptr;
  if (*index == kLoopWideIndex) return loop_kernel<256, true>;
  return p->nt == 256 ? loop_kernel<256, false> : loop_kernel<128, false>;
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0/fT [B, W, D], w2 [2D, D], aff [2, D], nm [B, W]
// -> traj [K, B, W, D], marg [K, B, W]; ws: the wide plan's workspace, B
// slices of gnn_propagation_loop_workspace floats (null for a staged plan).
// Returns a cudaError_t code.
int gnn_propagation_loop(const float* adjT, const float* s0, const float* fT, const float* w2,
                         const float* aff, const float* nm, float* traj, float* marg, int B,
                         int W, int D, int K, float thr, int act, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || K <= 0) return cudaErrorInvalidValue;
  LoopPlan p;
  size_t bytes;
  int index, wsf;
  const LoopFn fn = pick_loop(W, D, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(adjT, s0, fT, w2, aff, nm, traj, marg,
                                                            B, W, D, K, thr, act, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block gnn_propagation_loop's plan for this shape
// needs (0 for a staged plan), or -1 if no plan fits (AL and H1 unused).
int gnn_propagation_loop_workspace(int W, int D, int AL, int H1) {
  (void)AL;
  (void)H1;
  LoopPlan p;
  size_t bytes;
  int index, wsf;
  return pick_loop(W, D, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_loop launches
// for this shape (AL and H1 unused). Returns a cudaError_t code.
int gnn_propagation_loop_info(int W, int D, int AL, int H1, int* out) {
  (void)AL;
  (void)H1;
  LoopPlan p;
  size_t bytes;
  int index, wsf;
  const LoopFn fn = pick_loop(W, D, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` (kLoopPlans, then the wide plan) from now on, where it
// fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_propagation_loop_force_plan(int index) { g_force = index; }

}  // extern "C"
