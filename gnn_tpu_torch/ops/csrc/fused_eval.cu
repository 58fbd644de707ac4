// K4, the one-iteration eval kernel of the GNN fixed-point loop over the
// residual-coupled blocks, for Hopper (sm_90a), in plain fp32 on the CUDA
// cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K4 _step_kernel_T (launched by _fused_fwd_impl)  -> gnn_propagation_step
// K3, all K iterations of the residual-free blocks, is in eval_loop.cu.
//
// One iteration on one W-node block, node-major rows (D = width of the state
// read, H = width of the state written):
//   U   = s @ [Ws; Wa]^T               [W, 2H]
//   A   = adjT^T @ U[:, H:]            A[dst] = sum_src adjT[src, dst] * U[src, H:]
//   out = act(((U[:, :H] + A) + fT) (+ rT)) * scale + shift
// with fT = feats @ Wf^T + b, rT the residual term (already through Wa) and
// (scale, shift) the inference BatchNorm as an affine.
//
// Bound: a launch reads each block's adjacency (4*W*W bytes, 64 KiB at
// W = 128) once, its rows s, fT and rT, and writes out; the arcs present
// need 2*H flops each and the dense layer 4*D*H a node, so the least time is
// set by the bytes (chip_smoke.py: 0.0031 ms at the serving batch's 110 dep
// rows). At those rows a launch is 110 CTAs, less than one wave: its time is
// one CTA's staging, list build and products end to end.
//
// Design (K3's for one iteration with the residual term, eval_loop.cu), one
// CTA of NT threads a block row:
// - no resident adjacency: each column's nonzero entries go into a compact
//   list ([16][W] weights and uint8 sources, tile2.cuh::build_col_lists,
//   from coalesced 16-byte reads of device memory), in source order, and A
//   sums over it: 2*H an arc, not the dense W*W contraction. A column of more
//   than 16 entries is read from device memory, every entry, so a dense
//   block is exact;
// - every operand (w2 transposed, the affine, s, fT and rT) is staged with
//   cp.async, issued together ahead of the list build and waited on once;
// - U on NT / W threads a node, each taking a block of the 2H outputs, four
//   at a time from 16-byte reads of the transposed w2, each a chain over d
//   from 0 (the per-node kernel's order); U is kept node-major [W][2H | 1];
// - out for each node and four of its columns, walking the node's list once:
//   A over src ascending, as the per-node kernel associated its dense sum,
//   then ((U + A) + fT) (+ rT), written straight to device memory. Two
//   barriers a launch.
// No atomics: a repeat launch is bit-identical, and out is bit for bit the
// per-node K4's (the flagship's serving and training paths read it at every
// dep step). The staged plan (kStepThreads, kStepLists) takes W 32..128 with
// D and H up to 64 (209,536 bytes at W 128, D = H = 64); at W 128,
// D = H = 14 a CTA takes 49,936 bytes, four CTAs an SM: on an NVIDIA H100
// 0.0115 ms of device time at the 110 dep rows against the per-node kernel's
// 0.0239, and 0.0805 at the flat layout's 1536 rows against 0.2571 (PERF.md
// §6).
//
// The wide plan (index 1, mirrored by ops/fused.py::_step_wide), chosen only
// where the staged plan does not fit, takes every D and H: shared memory
// holds only the column lists and the list build's counts (11,392 bytes at
// W 128); s, fT, rT, w2 and the affine are read from device memory through
// the caches, and U [W][2H | 1] lies in a device-memory workspace the
// wrapper allocates (a block's slice each, gnn_propagation_step_workspace
// floats). The code is the staged plan's with those pointers, so a forced
// wide plan gives the staged plan's bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

// K4's plan: threads a CTA and the room of the column lists. On an NVIDIA
// H100 (PERF.md §6) 128 threads without lists ran 0.0185 and 0.1166 ms of
// device time against 0.0115 and 0.0805 at the 110 dep rows and the flat
// layout's 1536 rows; 256 and 512 threads without lists 0.0143 and 0.0111 at
// the dep rows, 0.1058 and 0.1102 at the flat layout; five CTAs an SM (48
// registers a thread, lists of 8) 0.0902 at the flat layout. None was kept.
// The wide plan has the same threads and lists.
constexpr int kStepThreads = 256, kStepLists = 16;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K4's shared memory (bytes for the list counts and
// sources, after the floats), each region a multiple of 16 bytes: U
// [W][2H | 1] (node-major; the list build's counts [NT / 32][W], as bytes,
// before U is formed), s [W][D | 1], fT and rT [W][H | 1] each, w2
// transposed w2T [D][J4] (J4 = 2H rounded up to 4, zero past 2H), the affine
// [2][H], the lists [kStepLists][W]. The wide plan: the lists, then the
// counts, sources and the list build's counts [NT / 32][W] as bytes; U at
// float offset 0 of a block's workspace slice of ws floats.
struct StepLayout {
  int u, s, f, r, w, aff, lw, ws;
  size_t cnt_b, idx_b, part_b, bytes;
};

__host__ __device__ inline StepLayout step_layout(int W, int D, int H, bool wide) {
  StepLayout L{};
  int o = 0;
  if (wide) {
    L.u = 0;
    L.ws = round4(W * ((2 * H) | 1));
    L.s = L.f = L.r = L.w = L.aff = -1;
    L.lw = o;
    o += kStepLists * W;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.part_b = L.idx_b + (size_t)kStepLists * W;
    L.bytes = L.part_b + (size_t)(kStepThreads / 32) * W;
    return L;
  }
  L.u = o;
  o += round4(W * ((2 * H) | 1));
  L.s = o;
  o += round4(W * (D | 1));
  L.f = o;
  o += round4(W * (H | 1));
  L.r = o;
  o += round4(W * (H | 1));
  L.w = o;
  o += D * round4(2 * H);
  L.aff = o;
  o += round4(2 * H);
  L.lw = o;
  o += kStepLists * W;
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + W;
  L.bytes = L.idx_b + (size_t)kStepLists * W;
  L.part_b = 0;
  L.ws = 0;
  return L;
}

// K4: one iteration over every block row, NT threads a CTA, one block row
// each; rT may be null; WIDE: the wide plan (ws its workspace).
template <bool WIDE>
__global__ void __launch_bounds__(kStepThreads, 4)
step_kernel(const float* __restrict__ adjT, const float* __restrict__ s,
            const float* __restrict__ rT, const float* __restrict__ fT,
            const float* __restrict__ w2, const float* __restrict__ aff,
            float* __restrict__ out, int W, int D, int H, int act, float* ws) {
  constexpr int NT = kStepThreads, E = kStepLists;
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const StepLayout L = step_layout(W, D, H, WIDE);
  // row strides: [W][D | 1] and [W][H | 1] buffers, or (wide) the operands
  const int DP = WIDE ? D : (D | 1), HP = WIDE ? H : (H | 1), UP = (2 * H) | 1,
            J4 = round4(2 * H);
  const int t = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * W;
  const float* adj = adjT + row0 * W;
  const bool has_res = rT != nullptr;
  float* U = WIDE ? ws + (size_t)blockIdx.x * L.ws + L.u : sm + L.u;
  const float* S = WIDE ? s + row0 * D : sm + L.s;
  const float* F = WIDE ? fT + row0 * H : sm + L.f;
  const float* R = WIDE ? rT + row0 * H : sm + L.r;
  const float* wT = sm + L.w;
  const float* af = WIDE ? aff : sm + L.aff;  // [scale; shift] x [H]
  float* lw = sm + L.lw;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;

  // ---- staging, issued together, waited on once
  if constexpr (!WIDE) {
    // wT [d][j] = w2 [j][d], in w2's order (whole rows of it a warp)
    for (int i = t; i < J4 * D; i += NT) {
      const int j = i / D, d = i % D;
      if (j < 2 * H)
        cp_async4(sm + L.w + d * J4 + j, w2 + i);
      else
        sm[L.w + d * J4 + j] = 0.0f;
    }
    for (int i = t; i < 2 * H; i += NT) cp_async4(sm + L.aff + i, aff + i);
    for (int i = t; i < W * D; i += NT)
      cp_async4(sm + L.s + (i / D) * DP + i % D, s + row0 * D + i);
    for (int i = t; i < W * H; i += NT) {
      const int o = (i / H) * HP + i % H;
      cp_async4(sm + L.f + o, fT + row0 * H + i);
      if (has_res) cp_async4(sm + L.r + o, rT + row0 * H + i);
    }
  }
  build_col_lists(adj, W, E, lw, idx, cnt, WIDE ? bytes + L.part_b : reinterpret_cast<uint8_t*>(U));
  cp_async_wait_all();
  __syncthreads();

  // ---- U = s @ w2^T, four outputs a 16-byte read of wT (wide: four rows of
  // w2), each a chain over d from 0; U's outputs [j0, j1) of node n are
  // thread t's
  const int tpn = NT / W, n = t % W, part = t / W;
  const int JB = round4((2 * H + tpn - 1) / tpn), j0 = part * JB, j1 = min(2 * H, j0 + JB);
  if (part < tpn)
    for (int q = j0; q < j1; q += 4) {
      float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int d = 0; d < D; ++d) {
        const float x = S[n * DP + d];
        float w4[4];
        if constexpr (WIDE) {
#pragma unroll
          for (int v = 0; v < 4; ++v) w4[v] = q + v < 2 * H ? w2[(size_t)(q + v) * D + d] : 0.0f;
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
  __syncthreads();  // U is full

  // ---- A = adjT^T @ U[:, H:] over the column lists (src ascending), four
  // columns of node m an item, then the epilogue, node-major out
  float* o = out + row0 * H;
  const int NB = (H + 3) / 4;  // blocks of four columns a node
  for (int i = t; i < W * NB; i += NT) {
    const int m = i / NB, h0 = 4 * (i % NB), nh = min(4, H - h0);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int c = cnt[m];
    if (c <= E) {
      for (int e = 0; e < c; ++e) {
        const float w = lw[e * W + m];
        const float* ua = U + idx[e * W + m] * UP + H + h0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < nh) a[v] = fmaf(w, ua[v], a[v]);
      }
    } else {
      for (int src = 0; src < W; ++src) {
        const float w = adj[(size_t)src * W + m];
        const float* ua = U + src * UP + H + h0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < nh) a[v] = fmaf(w, ua[v], a[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < nh) {
        const int h = h0 + v;
        float pre = (U[m * UP + h] + a[v]) + F[m * HP + h];
        if (has_res) pre += R[m * HP + h];
        o[m * H + h] = activate(act, pre) * af[h] + af[H + h];
      }
  }
}

int g_force = -1;  // gnn_propagation_step_force_plan

using StepFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, int, int, int, int, float*);

// K4's kernel for a shape: the staged plan (index 0) where it fits a CTA,
// else the wide plan (index 1), or plan g_force (>= 0) if it fits; nullptr
// if none. *bytes, *ws: the plan's shared memory and workspace floats a
// block.
StepFn pick_step(int W, int D, int H, size_t* bytes, int* index, int* ws) {
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i <= 1; ++i) {
    const StepLayout L = step_layout(W, D, H, i == 1);
    *bytes = L.bytes;
    if (L.bytes <= (size_t)kMaxSmemBytes) {
      *index = i;
      *ws = L.ws;
      break;
    }
    if (g_force >= 0) break;
  }
  if (*index < 0) return nullptr;
  return *index == 1 ? step_kernel<true> : step_kernel<false>;
}

}  // namespace

extern "C" {

// adjT [B, W, W], s [B, W, D], rT (nullable)/fT [B, W, H], w2 [2H, D],
// aff [2, H] -> out [B, W, H]; ws: the wide plan's workspace, B slices of
// gnn_propagation_step_workspace floats (null for the staged plan). Returns a
// cudaError_t code.
int gnn_propagation_step(const float* adjT, const float* s, const float* rT,
                         const float* fT, const float* w2, const float* aff, float* out,
                         int B, int W, int D, int H, int act, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || H <= 0) return cudaErrorInvalidValue;
  size_t bytes;
  int index, wsf;
  const StepFn fn = pick_step(W, D, H, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kStepThreads, bytes, static_cast<cudaStream_t>(stream)>>>(adjT, s, rT, fT, w2, aff, out,
                                                                    W, D, H, act, ws);
  return cudaGetLastError();
}

// The workspace floats a block gnn_propagation_step's plan for this shape
// needs (0 for the staged plan), or -1 if no plan fits (H1 unused).
int gnn_propagation_step_workspace(int W, int D, int H, int H1) {
  (void)H1;
  size_t bytes;
  int index, wsf;
  return pick_step(W, D, H, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_step launches
// for this shape (H1 unused). Returns a cudaError_t code.
int gnn_propagation_step_info(int W, int D, int H, int H1, int* out) {
  (void)H1;
  size_t bytes;
  int index, wsf;
  const StepFn fn = pick_step(W, D, H, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, kStepThreads);
}

// Launch plan `index` (0 the staged plan, 1 the wide plan) from now on, where
// it fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_propagation_step_force_plan(int index) { g_force = index; }

const char* gnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
