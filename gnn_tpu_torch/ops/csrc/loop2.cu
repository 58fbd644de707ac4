// K10, the two-layer eval loop, for Hopper (sm_90a), in plain fp32 on the
// CUDA cores (no TF32, no bf16), as register-tiled block products.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K10 _loop2_kernel_T (launched by _loop2_impl) -> gnn_propagation_loop2
//
// All K eval iterations of a residual-free W-node block, f the raw arc-label
// aggregation (the same every iteration), (scale, shift) the inference
// BatchNorm; iteration k on the state s (traj[k - 1], or s0):
//   marg[k] = nm where ||s - s_old|| > thr ||s_old|| (s_old: the state before
//             s, ones at k = 0), else 0
//   agg     = adjT^T @ s
//   s'      = act1(w1 @ act0(w0 @ [s | agg | f] + b0) + b1) * scale + shift
//   traj[k] = s'
//
// Bound: the dense layers cost 2*H1*(3D + AL) flops a node and iteration
// (13.5 kflop on the hidden-150 recipe, W = 128, D = 14, AL = 3, H1 = 150)
// and the block's arcs 2*D each, against 4*D + 4 bytes written a node and
// iteration: the least time is the operations at the card's 67 TFLOP/s fp32
// (chip_smoke.py::two_layer_bounds: 0.196 ms on the serving batch's 1440 loop
// rows, K = 5).
//
// Design (tile2.cuh's building blocks), one CTA of 256 threads a block:
// - the dense layers are block products on register tiles: thread t owns 4
//   nodes x 4 hidden units of a 32-unit chunk for h0 = x3 @ w0^T + b0 (act0
//   on the tile, y0 into a swizzled [32][W] tile, double-buffered) and 4
//   nodes x D/8 outputs of h1 += y0 @ w1^T, held in registers across the
//   chunks. Every operand read is a 16-byte shared-memory read feeding 16
//   FMAs (h0) or 4 + 4 per output column (h1), not one scalar weight read a
//   FMA at the odd stride C = 31;
// - the adjacency is not kept: at staging each destination's nonzero
//   entries (the block is ~1.6% dense, ~2 arcs a node) go into a compact
//   list in shared memory ([16][W] weights and uint8 sources); a destination
//   with more than 16 in-arcs reads its column of the adjacency from device
//   memory (every entry, so a dense block is exact). agg costs 2*D a arc, not
//   2*D*W a node;
// - the weights, the biases and the block's rows are staged once a launch
//   with cp.async; at the recipe a CTA takes 87.9 KB (a resident adjacency
//   alone is 66 KB), so two CTAs of 256 threads, 16 warps, fit an SM;
// - the movement test is summed over each node's D/8 owner threads into
//   shared memory and finished by one thread a node, with no atomics.
// Shapes whose layout does not fit take the leaner plan (tile2.cuh
// kLoop2Plans: one y0 tile, no lists, w1 read from device memory), which fits
// every shape the per-node kernel that this replaces took.

#include "tile2.cuh"

namespace {

using namespace gnn;

static_assert(kLoop2Plans[0].ut == 4 && kLoop2Plans[1].ut == 4, "K10 owns 4 units a thread");

template <int MAXF>
__global__ void __launch_bounds__(kTileThreads, 2)
loop2_tile_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                  const float* __restrict__ f, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ aff,
                  const float* __restrict__ nm, float* __restrict__ traj,
                  float* __restrict__ marg, int B, int W, int D, int AL, int H1, int K, float thr,
                  int act0, int act1, Tile2Plan p) {
  constexpr int DG = MAXF / 8, UT = 4, CH = 8 * UT;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kForward2, W, D, AL, H1, p);
  const int C = 2 * D + AL, S = L.S;
  float* X = base + L.x3;
  float* Y = base + L.yt;
  float* w0T = base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = base + L.b0;
  float* lw = base + L.lw;
  float* b1s = base + L.b1;
  float* affs = base + L.aff;
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  const int b = blockIdx.x, t = threadIdx.x;
  const int ng = t >> 3, dg = t & 7;  // node block; unit group / output column group
  const bool node_ok = 4 * ng < W;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  const W1Src w1src{w1s, w1, S, H1, p.w1g != 0};

  stage_tile_weights(w0, C, b0, 1, w1, b1, C, D, H1, S, w0T, w1s, b0s, b1s);
  for (int i = t; i < 2 * D; i += kTileThreads) cp_async4(affs + i, aff + i);
  stage_rowsT(s0 + row0 * D, W, D, X, 0);
  stage_rowsT(f + row0 * AL, W, AL, X, 2 * D);
  if (p.E > 0 && t < W) build_list(adj, W, t, p.E, true, lw, idx, cnt);
  cp_async_wait_all();
  __syncthreads();

  // Per-node movement sums of the owner threads, [8][W][2] over the first Y tile.
  float* red = Y;
  float dist[4], norm[4];
  auto flush_movement = [&](int k) {
    if (node_ok)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        red[2 * (dg * W + 4 * ng + n)] = dist[n];
        red[2 * (dg * W + 4 * ng + n) + 1] = norm[n];
      }
    __syncthreads();
    if (t < W) {
      float d2 = 0.0f, n2 = 0.0f;
      for (int g = 0; g < 8; ++g) {
        d2 = __fadd_rn(d2, red[2 * (g * W + t)]);
        n2 = __fadd_rn(n2, red[2 * (g * W + t) + 1]);
      }
      marg[((size_t)k * B + b) * W + t] = sqrtf(d2) > thr * sqrtf(n2) ? nm[row0 + t] : 0.0f;
    }
  };
  // before update 0 the old state is ones
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    dist[n] = norm[n] = 0.0f;
#pragma unroll
    for (int i = 0; i < DG; ++i) {
      const int d = dg + 8 * i;
      if (node_ok && d < D) {
        const float diff = X[d * W + 4 * ng + n] - 1.0f;
        dist[n] = __fadd_rn(dist[n], __fmul_rn(diff, diff));
        norm[n] = __fadd_rn(norm[n], 1.0f);
      }
    }
  }
  flush_movement(0);

  const int nch = (S + CH - 1) / CH;
  for (int k = 0; k < K; ++k) {
    const size_t kb = (size_t)k * B + b;
    // agg = adjT^T @ s into X rows [D, 2D): thread (node, half of the columns)
    {
      const int n = t & (kMaxW - 1);
      if (n < W)
        for (int d = t >> 7; d < D; d += 2)
          X[(D + d) * W + n] = line_dot(adj, W, n, true, p.E, lw, idx, cnt, X + d * W);
    }
    __syncthreads();  // X holds x3; the movement sums are read

    float h1[4][DG];
#pragma unroll
    for (int i = 0; i < DG; ++i) {
      const int d = dg + 8 * i;
#pragma unroll
      for (int n = 0; n < 4; ++n) h1[n][i] = d < D ? b1s[d] : 0.0f;
    }
    for (int ci = 0; ci < nch; ++ci) {
      const int j0 = ci * CH, jc = min(CH, S - j0);
      float* Yb = Y + (p.nbuf == 2 ? (ci & 1) : 0) * CH * W;
      if (node_ok && UT * dg < jc) {
        float a[4][UT];
        first_product<UT>(X, W, C, w0T + j0 + UT * dg, S, b0s + j0 + UT * dg, ng, a);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < UT; ++u) a[n][u] = activate(act0, a[n][u]);
        store_tile<UT>(Yb, UT * dg, ng, W, a);
      }
      __syncthreads();  // the chunk's y0 tile is full
      if (node_ok) second_product<UT, DG>(Yb, W, w1src, j0, jc, ng, dg, D, h1);
      // two tiles: the next chunk writes the other one, whose readers are past
      // the barrier above
      if (p.nbuf == 1) __syncthreads();
    }

    // s' = act1(h1) * scale + shift into X rows [0, D) and traj[k]; every
    // thread is past its reads of X (the last chunk's barrier)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      dist[n] = norm[n] = 0.0f;
      const int node = 4 * ng + n;
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int d = dg + 8 * i;
        if (node_ok && d < D) {
          const float y = activate(act1, h1[n][i]) * affs[d] + affs[D + d];
          const float old = X[d * W + node];
          const float diff = y - old;
          dist[n] = __fadd_rn(dist[n], __fmul_rn(diff, diff));
          norm[n] = __fadd_rn(norm[n], __fmul_rn(old, old));
          X[d * W + node] = y;
          traj[(kb * W + node) * D + d] = y;
        }
      }
    }
    __syncthreads();  // every thread is past its reads of the y0 tiles
    if (k + 1 < K) flush_movement(k + 1);
  }
}

using Loop2Fn = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, const float*, const float*, const float*, float*, float*,
                         int, int, int, int, int, int, float, int, int, Tile2Plan);

// The kernel and plan for a shape (nullptr if none fits).
Loop2Fn pick(int W, int D, int AL, int H1, Tile2Plan* p, size_t* bytes, int* index) {
  if (!pick_plan(kForward2, kLoop2Plans, W, D, AL, H1, p, bytes, index)) return nullptr;
  switch (width_class(D > AL ? D : AL)) {
    case 16:
      return loop2_tile_kernel<16>;
    case 32:
      return loop2_tile_kernel<32>;
    case 64:
      return loop2_tile_kernel<64>;
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], f [B, W, AL], w0 [H1, 2D + AL], b0 [H1],
// w1 [D, H1], b1 [D], aff [2, D], nm [B, W] -> traj [K, B, W, D],
// marg [K, B, W]. Returns a cudaError_t code.
int gnn_propagation_loop2(const float* adjT, const float* s0, const float* f, const float* w0,
                          const float* b0, const float* w1, const float* b1, const float* aff,
                          const float* nm, float* traj, float* marg, int B, int W, int D, int AL,
                          int H1, int K, float thr, int act0, int act1, void* stream) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index;
  const Loop2Fn fn = pick(W, D, AL, H1, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, f, w0, b0, w1, b1, aff, nm, traj, marg, B, W, D, AL, H1, K, thr, act0, act1, p);
  return cudaGetLastError();
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_loop2 launches
// for this shape. Returns a cudaError_t code.
int gnn_propagation_loop2_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index;
  const Loop2Fn fn = pick(W, D, AL, H1, &p, &bytes, &index);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

}  // extern "C"
