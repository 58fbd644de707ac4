// K9, one iteration of the two-layer eval step, for Hopper (sm_90a), in
// plain fp32 on the CUDA cores (no TF32, no bf16), on the register-tiled
// block products of K10's forward (tile2.cuh): a state net dense0 -> act0 ->
// dense1 -> act1 with a hidden width H1 (the hidden-150 accuracy recipe).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K9  _step2_kernel_T (launched by _step2_impl) -> gnn_propagation_step2
// K10 (the eval loop) and K12 (the dropout-training loop) are in loop2.cu,
// K12's reverse, K13, in train_loop2_bwd.cu.
//
// One iteration on one W-node block of a residual-coupled block, node-major
// rows; rT is the raw residual aggregation, added to agg:
//   agg = adjT^T @ s + rT                agg[dst] = sum_src adjT[src, dst] * s[src]
//   x3  = [s | agg | f]                  2D + AL wide; f the arc-label aggregation
//   y0  = act0(w0 @ x3 + b0)             w0 = [Ws | Wa | Wf], [H1, 2D + AL]
//   s'  = act1(w1 @ y0 + b1) * scale + shift
// gnn_tpu's kernel multiplies first and contracts the adjacency H1 wide
// (2*W*W*H1 flops a block) and reads a hoisted H1-wide feature term
// Wf @ f + b0; this aggregates the D-wide state (2*D flops an arc, the same
// linear map) and forms the feature term from f's AL columns, reading AL/H1
// of those bytes.
//
// Bound: the dense layers cost 2*H1*(3D + AL) flops a node against
// 8*D + 4*AL bytes a node and the block's adjacency (4*W*W bytes) read once:
// the least time is set by the operations at the card's fp32 rate
// (chip_smoke.py::two_layer_bounds: 0.0030 ms on the serving batch's 110
// dep rows). A launch there is 110 CTAs, less than one wave on 132 SMs, so
// its time is one CTA's staging, list build and products end to end, which
// no bound on the whole card's rate sees; the flat layout's 1536 rows run
// about six waves of two CTAs an SM.
//
// Design: K14's tiled forward (bn2_fwd.cu) for one iteration without the
// BatchNorm, one CTA of 256 threads a block:
// - h0 and h1 as block products on 4-node x 4-unit register tiles
//   (tile2.cuh first_product3, second_product), y0 through the swizzled
//   unit-major tile, two tiles in turn; not one thread a node looping over
//   H1 units with a scalar weight read a FMA at the odd stride C;
// - the aggregation by destination over compact column lists ([16][W]
//   weights and uint8 sources) built at staging from coalesced 16-byte reads
//   of the adjacency (tile2.cuh::build_col_lists), in source order, so the
//   sum has the dense contraction's nonzero terms in its order; a column of
//   more than 16 entries is read from device memory, every entry, so a dense
//   block is exact; rT is added after the aggregation, as the per-node
//   kernel added it;
// - every operand (w0 transposed, w1, the biases, the affine, s and f
//   transposed into x3's rows, rT into the row buffer) is staged with
//   cp.async, issued together and waited on once;
// - h0 in the per-node kernel's association (three column chains added as
//   (s + a) + (f + b0)) and h1 in its order (from b1, j ascending), act1 and
//   the affine in the epilogue, so the output is bit for bit the per-node
//   K9's; it leaves through the node-major row buffer [W][D | 1] by
//   coalesced writes. No atomics: a repeat launch is bit-identical, and every
//   plan gives the same bits.
// The plans (tile2.cuh kStep2Plans, mirrored by ops/fused2.py::_PLANS["K9"]):
// the first builds the lists and stages w1, two y0 tiles (95,568 bytes at
// the recipe, two CTAs an SM); the leanest (no lists, w1 read from device
// memory) fits every shape the per-node K9 took. The wide plan (tile2.cuh
// kTile2Wide, chosen only where neither fits) takes every D, AL and H1: x3,
// the row buffer and h1 in a workspace slice a block (the wrapper allocates
// gnn_propagation_step2_workspace floats a block), the weights, the biases
// and the affine read from device memory, the same chains (a forced wide
// plan gives the staged plans' bits).

#include "tile2.cuh"

namespace {

using namespace gnn;

static_assert(kStep2Plans[0].ut == 4 && kStep2Plans[1].ut == 4, "K9 owns 4 units a thread");

int g_force = -1;  // gnn_propagation_step2_force_plan

// K9: one eval iteration of residual-coupled blocks; rT [B, W, D] nullable;
// WIDE: the wide plan (ws its workspace).
template <int MAXF, bool WIDE>
__global__ void __launch_bounds__(kTileThreads, 2)
step2_tile_kernel(const float* __restrict__ adjT, const float* __restrict__ s,
                  const float* __restrict__ rT, const float* __restrict__ f,
                  const float* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ aff, float* __restrict__ out, int W, int D, int AL,
                  int H1, int act0, int act1, Tile2Plan p, float* ws) {
  constexpr int DG = MAXF / 8, UT = 4, CH = 8 * UT;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const Tile2Layout L = tile2_layout(kStep2, W, D, AL, H1, p, WIDE);
  const int C = 2 * D + AL, S = L.S, DP = D | 1;
  float* WB = WIDE ? ws + (size_t)blockIdx.x * L.ws : base;  // x3, the row buffer, h1
  float* X = WB + L.x3;
  float* Y = base + L.yt;
  float* w0T = WIDE ? nullptr : base + L.w0;
  float* w1s = p.w1g ? nullptr : base + L.w1;
  float* b0s = WIDE ? nullptr : base + L.b0;
  float* lw = base + L.lw;
  const float* b1s = WIDE ? b1 : base + L.b1;
  const float* affs = WIDE ? aff : base + L.aff;  // [scale; shift] x [D]
  float* A = WB + L.ab;                            // [W][DP]: rT, then the output
  float* HW = WB + L.hw;
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  const int t = threadIdx.x;
  const int ng = t >> 3, dg = t & 7;  // node block; unit group / output column group
  const bool node_ok = 4 * ng < W;
  const size_t row0 = (size_t)blockIdx.x * W;
  const float* adj = adjT + row0 * W;
  const W1Src w1src{w1s, w1, S, H1, p.w1g != 0};

  // ---- staging, issued together, waited on once (wide: into the workspace)
  if constexpr (WIDE) {
    stage_rowsT<true>(s + row0 * D, W, D, X, 0);
    stage_rowsT<true>(f + row0 * AL, W, AL, X, 2 * D);
    if (rT != nullptr)
      for (int i = t; i < W * D; i += kTileThreads) A[(i / D) * DP + i % D] = rT[row0 * D + i];
  } else {
    stage_tile_weights(w0, C, b0, 1, w1, b1, C, D, H1, S, w0T, w1s, b0s, base + L.b1);
    for (int i = t; i < 2 * D; i += kTileThreads) cp_async4(base + L.aff + i, aff + i);
    stage_rowsT(s + row0 * D, W, D, X, 0);         // x3 rows [0, D): s
    stage_rowsT(f + row0 * AL, W, AL, X, 2 * D);   // rows [2D, C): f
    if (rT != nullptr)
      for (int i = t; i < W * D; i += kTileThreads)
        cp_async4(A + (i / D) * DP + i % D, rT + row0 * D + i);
  }
  if (p.E > 0) build_col_lists(adj, W, p.E, lw, idx, cnt, reinterpret_cast<uint8_t*>(Y));
  cp_async_wait_all();
  __syncthreads();

  // ---- agg = adjT^T @ s (+ rT) into x3 rows [D, 2D)
  for (int i = t; i < W * D; i += kTileThreads) {
    const int n = i % W, d = i / W;
    float a = line_dot(adj, W, n, true, p.E, lw, idx, cnt, X + d * W);
    if (rT != nullptr) a += A[n * DP + d];
    X[(D + d) * W + n] = a;
  }
  __syncthreads();

  // ---- h1 = w1 @ act0(w0 @ x3 + b0) + b1 on the register tiles (wide: 64
  // outputs at a time, parked in HW between chunks)
  float h1[4][DG];
  if constexpr (!WIDE) h1_bias<DG>(h1, b1s, dg, D);
  const int nch = (S + CH - 1) / CH;
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * CH, jc = min(CH, S - j0);
    float* Yb = Y + (p.nbuf == 2 ? (ci & 1) : 0) * CH * W;
    if (node_ok && UT * dg < jc) {
      float a[4][UT];
      if constexpr (WIDE)
        first_product3(X, W, D, C, W0Dev{w0, b0, C, 1, H1, j0 + UT * dg}, ng, a);
      else
        first_product3(X, W, D, C, w0T + j0 + UT * dg, S, b0s + j0 + UT * dg, ng, a);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < UT; ++u) a[n][u] = activate(act0, a[n][u]);
      store_tile<UT>(Yb, UT * dg, ng, W, a);
    }
    __syncthreads();  // the chunk's y0 tile is full
    if constexpr (WIDE) {
      for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
        if (ci == 0)
          h1_bias<DG>(h1, b1s, d0 + dg, D);
        else
          tile_io<false>(h1, HW, W, ng, d0 + dg, D);
        second_product<UT, DG>(Yb, W, w1src, j0, jc, ng, d0 + dg, D, h1);
        tile_io<true>(h1, HW, W, ng, d0 + dg, D);
      }
    } else if (node_ok) {
      second_product<UT, DG>(Yb, W, w1src, j0, jc, ng, dg, D, h1);
    }
    // two tiles: the next chunk writes the other one, whose readers are past
    // the barrier above
    if (p.nbuf == 1) __syncthreads();
  }

  // ---- act1 and the affine into the row buffer (rT was read before the
  // barriers above), outputs d0 + dg + 8 i
  auto finish = [&](int d0) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int d = d0 + dg + 8 * i;
        if (d < D)
          A[(4 * ng + n) * DP + d] = activate(act1, h1[n][i]) * affs[d] + affs[D + d];
      }
  };
  if constexpr (WIDE) {
    for (int d0 = 0; node_ok && d0 < D; d0 += kWideOut) {
      tile_io<false>(h1, HW, W, ng, d0 + dg, D);
      finish(d0);
    }
  } else if (node_ok) {
    finish(0);
  }
  __syncthreads();

  // ---- out, coalesced
  for (int i = t; i < W * D; i += kTileThreads) out[row0 * D + i] = A[(i / D) * DP + i % D];
}

using Step2Fn = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, const float*, const float*, const float*, float*, int, int,
                         int, int, int, int, Tile2Plan, float*);

// K9's kernel and plan for a shape: the first plan of kStep2Plans that fits,
// else the wide plan (index 2), or plan g_force (>= 0) if it fits; nullptr if
// none. *ws: the plan's workspace floats a block.
Step2Fn pick_step2(int W, int D, int AL, int H1, Tile2Plan* p, size_t* bytes, int* index,
                   int* ws) {
  if (!pick_plan(kStep2, kStep2Plans, W, D, AL, H1, p, bytes, index, g_force, ws)) return nullptr;
  if (*ws > 0) return step2_tile_kernel<64, true>;
  return D <= 16 ? step2_tile_kernel<16, false>
                 : D <= 32 ? step2_tile_kernel<32, false> : step2_tile_kernel<64, false>;
}

}  // namespace

extern "C" {

// adjT [B, W, W], s [B, W, D], rT [B, W, D] (nullable), f [B, W, AL],
// w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D], aff [2, D] -> out [B, W, D];
// ws: the wide plan's workspace, B slices of gnn_propagation_step2_workspace
// floats (null for a staged plan). Returns a cudaError_t code.
int gnn_propagation_step2(const float* adjT, const float* s, const float* rT, const float* f,
                          const float* w0, const float* b0, const float* w1, const float* b1,
                          const float* aff, float* out, int B, int W, int D, int AL, int H1,
                          int act0, int act1, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || AL <= 0 || H1 <= 0) return cudaErrorInvalidValue;
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Step2Fn fn = pick_step2(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s, rT, f, w0, b0, w1, b1, aff, out, W, D, AL, H1, act0, act1, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block the plan gnn_propagation_step2 picks for this
// shape needs (0 for a staged plan), or -1 if none fits.
int gnn_propagation_step2_workspace(int W, int D, int AL, int H1) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  return pick_step2(W, D, AL, H1, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_step2 launches
// for this shape. Returns a cudaError_t code.
int gnn_propagation_step2_info(int W, int D, int AL, int H1, int* out) {
  Tile2Plan p;
  size_t bytes;
  int index, wsf;
  const Step2Fn fn = pick_step2(W, D, AL, H1, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` of kStep2Plans (2: the wide plan) from now on, where it
// fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_propagation_step2_force_plan(int index) { g_force = index; }

}  // extern "C"
