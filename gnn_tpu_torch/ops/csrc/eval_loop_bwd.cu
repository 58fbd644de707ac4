// K5, the backward of the eval propagation loop K3, for Hopper (sm_90a), in
// plain fp32 on the CUDA cores (no TF32, no bf16): the gradient of a state
// net without dropout and BatchNorm trained through the eval kernels.
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K5 _loop_bwd_kernel (launched by _loop_bwd_impl) -> gnn_propagation_loop_bwd
// Its forward, K3, is in eval_loop.cu.
//
// All K reverse iterations of K3 on one W-node block, in K3's algebra (the
// dense layer reassociated through the aggregation, H == D), node-major rows:
//   u   = s_in @ [Ws; Wa]^T,  h = u[:, :H] + adjT^T @ u[:, H:] + fT
//   gy  = g_traj[k] + gs;     with an affine (scale; shift) after the activation:
//         daff += (sum gy * act(h), sum gy),  gy *= scale
//   dh  = gy * act'(h);       dfT += dh (fT is loop-invariant)
//   dua = adjT @ dh           dua[src] = sum_dst adjT[src, dst] * dh[dst]
//   du  = [dh | dua];         dw2 += du^T @ s_in;  gs = du @ [Ws; Wa]
// with s_in = traj[k - 1], or s0 for k = 0.
//
// Bound: a launch reads each block's adjacency (64 KiB at W = 128) once for
// all K reverse steps, streams s0, fT, K - 1 trajectories and K cotangents,
// and writes gs, dfT and the per-block dw2 (and daff) partials; the arcs
// present need 4*D flops each a step and the dense layers 12*D*D a node, so
// the least time is set by bytes (chip_smoke.py::bnfree_bounds: 0.053 ms on
// the training batch's 1104 loop rows, K = 5).
//
// Design (K3's forward and K8's reverse, eval_loop.cu and
// train_loop_bwd.cu), one CTA of 256 threads a block:
// - no resident adjacency: the block's column lists (the sources of each
//   destination, for the recomputed aggregation of u[:, H:]) and row lists
//   (the destinations of each source, for dua) are built once a launch from
//   coalesced 16-byte reads (tile2.cuh::build_col_lists, build_row_lists),
//   in source and destination order, and kept for all K reverse steps; a
//   line of more than 8 entries is read from device memory, every entry, so
//   a dense block is exact. Both aggregations cost 2*D an arc, not the dense
//   2*D*W a node;
// - s_in lies transposed in shared memory ([D][W]), du transposed beside it
//   ([2D][W + 4]: dh rows, then dua rows), so the dw2 sums are block
//   products over the node dimension by 16-byte reads; each dw2 entry is one
//   chain over the block's nodes in order a step, added to a partial kept in
//   shared memory across the K steps (in device memory in the second plan)
//   and written once a launch;
// - NT / W threads a node, each taking a block of u's outputs and, in the
//   later phases, every (NT / W)-th block of four columns: u as K3 forms it
//   (node-major [W][2D | 1], four outputs at a time from 16-byte reads of the
//   transposed w2, each a chain over d from 0); h = (u[:, :H] + A) + fT with
//   A over the node's column list (src ascending), gy, the affine's product,
//   dh and dfT; dua over its row list (dst ascending) from 0; gs, j ascending
//   with the per-node interleave (gs = fma(dh[j], Ws[j], gs), then
//   fma(dua[j], Wa[j], gs)), from 16-byte reads of w2. A list entry is read
//   once for four columns, and no per-thread register array is wider than
//   four. The daff sums are each a plain-add chain over the block's nodes in
//   order, on the CTA's last threads;
// - a step's rows (s_in, fT, g_traj) are read from device memory where they
//   are used, as K8 reads them.
// So gs, dw2, dfT and daff are bit for bit the per-node kernel's that this
// replaced (one thread a node, a resident [W][W + 1] adjacency contracted
// densely by columns and again by rows each step): the same sums in the same
// orders. No atomics: a repeat launch is bit-identical and every plan gives
// the same bits. At the flagship's widths (W 128, D 14) a CTA of plan 0
// takes 67,760 bytes, three CTAs an SM. The plans (kLoopBwdPlans: whether
// w2, dfT and the dw2 partials are staged) are mirrored by
// ops/fused.py::_loop_bwd_plan; the second fits every shape the per-node K5
// took. A third plan of 128 threads without lists (every line read from
// device memory) ran 8x slower on an NVIDIA H100 and was dropped (PERF.md
// section 6).
//
// The wide plan (index 2, the second plan with its [W][D]-sized regions
// moved out of shared memory; mirrored by ops/fused.py::_loop_bwd_wide),
// chosen only where no staged plan fits, takes every D: s_in, du, u, gs and
// the daff partials lie in a device-memory workspace the wrapper allocates
// (a block's slice each, gnn_propagation_loop_bwd_workspace floats), w2 and
// the affine's scale are read through the caches, dfT and the dw2 partials
// are summed in the outputs, and shared memory holds only the two list sets
// and the column-list build's counts (11,520 bytes at W 128, whatever D is).
// The code is the second plan's with those pointers: a forced wide plan
// gives the staged plans' bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

// A K5 plan: whether w2, dfT and the dw2 partials are staged in shared
// memory (else w2 is read through the L1/L2 caches and dfT and dw2 are summed
// in the outputs).
struct LoopBwdPlan {
  int st;
};

constexpr LoopBwdPlan kLoopBwdPlans[] = {{1}, {0}};
// the wide plan, after the staged ones: the second plan's regions in the
// workspace
constexpr LoopBwdPlan kLoopBwdWide = {0};
constexpr int kLoopBwdWideIndex = sizeof(kLoopBwdPlans) / sizeof(kLoopBwdPlans[0]);
constexpr int NT = kTileThreads;
constexpr int kListRoom = 8;  // entries a column or row list holds

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K5's shared memory (bytes for the lists' counts and
// indices, after the floats), each region a multiple of 16 bytes: s_in S
// [D][W] (transposed), du DU [2D][W + 4] (transposed), u U [W][2D | 1]
// (node-major; h, then the affine's product, over its first D columns; the
// column-list build's counts [NT / 32][W], as bytes, before the first step),
// gs GS [W][D | 1] (gy, then the next step's gs), the daff partials [2][D],
// the affine's scale [D]; with st dfT [W][D | 1], the dw2 partials [2D][D],
// w2 transposed w2T [D][J4] (J4 = 2D rounded up to 4, zero past 2D) and w2
// [2D][D4] (D4 = D rounded up to 4, zero past D); the column lists [8][W],
// the row lists [8][W]. The wide plan: s_in, du, u, gs and the daff
// partials, in that order, in a block's workspace slice of ws floats; in
// shared memory the two list sets, then their bytes and the column-list
// build's counts [NT / 32][W].
struct LoopBwdLayout {
  int s, du, u, gs, daff, sc, df, dw, wt, wr, lc, lr, ws;
  size_t cc_b, ic_b, cr_b, ir_b, part_b, bytes;
};

__host__ __device__ inline LoopBwdLayout bwd_layout(int W, int D, const LoopBwdPlan& p,
                                                    bool wide) {
  LoopBwdLayout L{};
  int o = 0;
  if (wide) {
    L.s = o;
    o += D * W;
    L.du = o;
    o += 2 * D * (W + 4);
    L.u = o;
    o += round4(W * ((2 * D) | 1));
    L.gs = o;
    o += round4(W * (D | 1));
    L.daff = o;
    o += round4(2 * D);
    L.ws = o;
    L.sc = L.df = L.dw = L.wt = L.wr = -1;
    o = 0;
    L.lc = o;
    o += kListRoom * W;
    L.lr = o;
    o += kListRoom * W;
    L.cc_b = sizeof(float) * (size_t)o;
    L.ic_b = L.cc_b + W;
    L.cr_b = L.ic_b + (size_t)kListRoom * W;
    L.ir_b = L.cr_b + W;
    L.part_b = L.ir_b + (size_t)kListRoom * W;
    L.bytes = L.part_b + (size_t)(NT / 32) * W;
    return L;
  }
  L.s = o;
  o += D * W;
  L.du = o;
  o += 2 * D * (W + 4);
  L.u = o;
  o += round4(W * ((2 * D) | 1));
  L.gs = o;
  o += round4(W * (D | 1));
  L.daff = o;
  o += round4(2 * D);
  L.sc = o;
  o += round4(D);
  L.df = L.dw = L.wt = L.wr = -1;
  if (p.st) {
    L.df = o;
    o += round4(W * (D | 1));
    L.dw = o;
    o += round4(2 * D * D);
    L.wt = o;
    o += D * round4(2 * D);
    L.wr = o;
    o += 2 * D * round4(D);
  }
  L.lc = o;
  o += kListRoom * W;
  L.lr = o;
  o += kListRoom * W;
  L.cc_b = sizeof(float) * (size_t)o;
  L.ic_b = L.cc_b + W;
  L.cr_b = L.ic_b + (size_t)kListRoom * W;
  L.ir_b = L.cr_b + W;
  L.bytes = L.ir_b + (size_t)kListRoom * W;
  L.part_b = 0;
  L.ws = 0;
  return L;
}

// K5: the K reverse iterations of K3 over every block, one CTA of NT
// threads a block; WIDE: the wide plan (ws its workspace).
template <bool WIDE>
__global__ void __launch_bounds__(NT, 3)
loop_bwd_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                const float* __restrict__ traj, const float* __restrict__ fT,
                const float* __restrict__ w2, const float* __restrict__ aff,
                const float* __restrict__ g_traj, float* __restrict__ gs_out,
                float* __restrict__ dw2_out, float* __restrict__ dfT_out,
                float* __restrict__ daff_out, int B, int W, int D, int K, int act,
                LoopBwdPlan p, float* ws) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const LoopBwdLayout L = bwd_layout(W, D, p, WIDE);
  const int DP = D | 1, UP = (2 * D) | 1, GP = W + 4, J4 = round4(2 * D), D4 = round4(D);
  const int WD = W * D;
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  const bool has_aff = aff != nullptr;
  float* base = WIDE ? ws + (size_t)b * L.ws : sm;  // the regions of s_in .. daff
  float* S = base + L.s;
  float* DU = base + L.du;
  float* U = base + L.u;
  float* GS = base + L.gs;
  float* DAF = base + L.daff;
  const float* sc = WIDE ? aff : sm + L.sc;
  // dfT and the dw2 partials: in shared memory, or summed in the outputs
  float* DF = p.st ? sm + L.df : dfT_out + row0 * D;
  const int dfs = p.st ? DP : D;
  float* DW = p.st ? sm + L.dw : dw2_out + (size_t)b * 2 * D * D;
  float* wT = p.st ? sm + L.wt : nullptr;
  float* wR = p.st ? sm + L.wr : nullptr;
  float* lc = sm + L.lc;
  float* lr = sm + L.lr;
  uint8_t* cc = bytes + L.cc_b;
  uint8_t* ic = bytes + L.ic_b;
  uint8_t* cr = bytes + L.cr_b;
  uint8_t* ir = bytes + L.ir_b;

  // ---- staging, issued together, waited on once; the sums' partials zeroed
  if (p.st) {
    // w2T [d][j] = w2 [j][d], in w2's order (whole rows of it a warp)
    for (int i = t; i < J4 * D; i += NT) {
      const int j = i / D, d = i % D;
      if (j < 2 * D)
        cp_async4(wT + d * J4 + j, w2 + i);
      else
        wT[d * J4 + j] = 0.0f;
    }
    for (int i = t; i < 2 * D * D4; i += NT) {
      const int j = i / D4, d = i % D4;
      if (d < D)
        cp_async4(wR + i, w2 + j * D + d);
      else
        wR[i] = 0.0f;
    }
  }
  if (has_aff && !WIDE)
    for (int i = t; i < D; i += NT) cp_async4(sm + L.sc + i, aff + i);
  for (int i = t; i < W * DP; i += NT) GS[i] = 0.0f;  // gs = 0 before the last step
  for (int i = t; i < W * dfs; i += NT) DF[i] = 0.0f;
  for (int i = t; i < 2 * D * D; i += NT) DW[i] = 0.0f;
  for (int i = t; i < 2 * D; i += NT) DAF[i] = 0.0f;
  build_col_lists(adj, W, kListRoom, lc, ic, cc,
                  WIDE ? bytes + L.part_b : reinterpret_cast<uint8_t*>(U));
  build_row_lists(adj, W, kListRoom, lr, ir, cr);
  cp_async_wait_all();
  __syncthreads();

  // thread t serves node n (NT / W threads a node; at W = 96 the last threads
  // take none): u's outputs [j0, j1), and in the later phases every
  // (NT / W)-th block of four columns from 4 * part
  const int tpn = NT / W, n = t % W, part = t / W;
  const bool mine = part < tpn;
  const int JB = round4((2 * D + tpn - 1) / tpn), j0 = part * JB, j1 = min(2 * D, j0 + JB);
  const int cstep = 4 * tpn;
  // node n's column and row list counts (above kListRoom: read from device
  // memory)
  const int ccn = cc[n], crn = cr[n];
  // the dw2 work items: row j of du, columns d0, d0 + 1 of s_in
  const int ndw = 2 * D * ((D + 1) / 2);
  for (int k = K - 1; k >= 0; --k) {
    const size_t kb = (size_t)k * B + b;
    // ---- s_in transposed into S
    if (mine) {
      const float* s_in = k > 0 ? traj + ((size_t)(k - 1) * B + b) * WD : s0 + row0 * D;
      for (int d = part; d < D; d += tpn) S[d * W + n] = s_in[n * D + d];
    }
    __syncthreads();

    // ---- u = s_in @ w2^T, four outputs at a time, each a chain over d from 0
    if (mine)
      for (int q = j0; q < j1; q += 4) {
        float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = 0; d < D; ++d) {
          const float x = S[d * W + n];
          float w4[4];
          if (wT != nullptr) {
            ldv<4>(wT + d * J4 + q, w4);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v) w4[v] = q + v < 2 * D ? w2[(q + v) * D + d] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) u[v] = fmaf(w4[v], x, u[v]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (q + v < j1) U[n * UP + q + v] = u[v];
      }
    __syncthreads();  // U is full

    // ---- node n, columns c0 .. c0 + 3: h = (u[:, :H] + A) + fT with A over
    // the column list (src ascending); gy = g_traj[k] + gs into GS; with the
    // affine gy * act(h) over U's column c and gy scaled; dh into DU's row c,
    // added to dfT
    if (mine) {
      const float* gk = g_traj + kb * WD + n * D;
      const float* fk = fT + (row0 + n) * D;
      for (int c0 = 4 * part; c0 < D; c0 += cstep) {
        float g4[4], f4[4], a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          g4[v] = c0 + v < D ? gk[c0 + v] : 0.0f;
          f4[v] = c0 + v < D ? fk[c0 + v] : 0.0f;
        }
        auto add = [&](float w, int src) {
          const float* ua = U + src * UP + D + c0;
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (c0 + v < D) a[v] = fmaf(w, ua[v], a[v]);
        };
        if (ccn <= kListRoom) {
          for (int e = 0; e < ccn; ++e) add(lc[e * W + n], ic[e * W + n]);
        } else {
          for (int src = 0; src < W; ++src) add(adj[(size_t)src * W + n], src);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = c0 + v;
          if (c < D) {
            const float h = (U[n * UP + c] + a[v]) + f4[v];
            float gy = g4[v] + GS[n * DP + c];
            GS[n * DP + c] = gy;
            float ag;
            if (has_aff) {
              float y;
              act_and_grad(act, h, y, ag);
              U[n * UP + c] = gy * y;
              gy *= sc[c];
            } else {
              ag = act_grad(act, h);
            }
            const float dh = gy * ag;
            DU[c * GP + n] = dh;
            DF[n * dfs + c] += dh;
          }
        }
      }
    }
    __syncthreads();  // DU's dh rows are full; U and GS hold the affine's terms

    // ---- node n, columns c0 .. c0 + 3: dua over the row list (dst
    // ascending) into DU's rows [D, 2D); with the affine, this block's daff +=
    // (sum gy * act(h), sum gy), each a chain over the nodes in order
    if (mine)
      for (int c0 = 4 * part; c0 < D; c0 += cstep) {
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        auto add = [&](float w, int dst) {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (c0 + v < D) a[v] = fmaf(w, DU[(c0 + v) * GP + dst], a[v]);
        };
        if (crn <= kListRoom) {
          for (int e = 0; e < crn; ++e) add(lr[e * W + n], ir[e * W + n]);
        } else {
          for (int dst = 0; dst < W; ++dst) add(adj[(size_t)n * W + dst], dst);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (c0 + v < D) DU[(D + c0 + v) * GP + n] = a[v];
      }
    if (has_aff)
      for (int o = NT - 1 - t; o < 2 * D; o += NT) {  // the CTA's last threads
        float acc = 0.0f;
        if (o < D) {
          for (int m = 0; m < W; ++m) acc += U[m * UP + o];
        } else {
          for (int m = 0; m < W; ++m) acc += GS[m * DP + o - D];
        }
        DAF[o] += acc;
      }
    __syncthreads();  // DU is full

    // ---- dw2[j][d] += du^T @ s_in, one chain over the nodes in order a
    // step, four nodes a 16-byte read
    for (int q = t; q < ndw; q += NT) {
      const int j = q % (2 * D), d0 = 2 * (q / (2 * D));
      const bool two = d0 + 1 < D;
      const float* du = DU + j * GP;
      const float* x0 = S + d0 * W;
      const float* x1 = S + (two ? d0 + 1 : d0) * W;
      float a0 = 0.0f, a1 = 0.0f;
      for (int bb = 0; bb < W / 4; ++bb) {
        float hv[4], v0[4], v1[4];
        ldv<4>(du + 4 * bb, hv);
        ldv<4>(x0 + 4 * bb, v0);
        ldv<4>(x1 + 4 * bb, v1);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          a0 = fmaf(hv[m], v0[m], a0);
          a1 = fmaf(hv[m], v1[m], a1);
        }
      }
      DW[j * D + d0] += a0;
      if (two) DW[j * D + d0 + 1] += a1;
    }
    // ---- gs = du @ [Ws; Wa] into GS, node n's columns c0 .. c0 + 3, j
    // ascending
    if (mine)
      for (int c0 = 4 * part; c0 < D; c0 += cstep) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int j = 0; j < D; ++j) {
          const float dh = DU[j * GP + n], da = DU[(D + j) * GP + n];
          float ws[4], wa[4];
          if (wR != nullptr) {
            ldv<4>(wR + j * D4 + c0, ws);
            ldv<4>(wR + (D + j) * D4 + c0, wa);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              ws[v] = c0 + v < D ? w2[j * D + c0 + v] : 0.0f;
              wa[v] = c0 + v < D ? w2[(D + j) * D + c0 + v] : 0.0f;
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[v] = fmaf(dh, ws[v], acc[v]);
            acc[v] = fmaf(da, wa[v], acc[v]);
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (c0 + v < D) GS[n * DP + c0 + v] = acc[v];
      }
    __syncthreads();  // S, U and DU are rewritten by the next step
  }

  // ---- gs, dfT and the partials out
  for (int i = t; i < WD; i += NT) gs_out[row0 * D + i] = GS[(i / D) * DP + i % D];
  if (p.st) {
    for (int i = t; i < WD; i += NT) dfT_out[row0 * D + i] = DF[(i / D) * DP + i % D];
    for (int i = t; i < 2 * D * D; i += NT) dw2_out[(size_t)b * 2 * D * D + i] = DW[i];
  }
  if (has_aff)
    for (int i = t; i < 2 * D; i += NT) daff_out[(size_t)b * 2 * D + i] = DAF[i];
}

int g_force = -1;  // gnn_propagation_loop_bwd_force_plan

using LoopBwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*, float*, int, int,
                           int, int, int, LoopBwdPlan, float*);

// K5's kernel and plan for a shape: the first plan of kLoopBwdPlans that
// fits a CTA, else the wide plan (index kLoopBwdWideIndex), or plan g_force
// (>= 0) if it fits; nullptr (bytes: the last plan's) if none. *ws: the
// plan's workspace floats a block.
LoopBwdFn pick_bwd(int W, int D, LoopBwdPlan* p, size_t* bytes, int* index, int* ws) {
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i <= kLoopBwdWideIndex; ++i) {
    const bool wide = i == kLoopBwdWideIndex;
    const LoopBwdPlan plan = wide ? kLoopBwdWide : kLoopBwdPlans[i];
    const LoopBwdLayout L = bwd_layout(W, D, plan, wide);
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
  return *index == kLoopBwdWideIndex ? loop_bwd_kernel<true> : loop_bwd_kernel<false>;
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0/fT [B, W, D], traj/g_traj [K, B, W, D], w2 [2D, D],
// aff [2, D] (null: no affine) -> gs, dfT [B, W, D], dw2 [B, 2D, D] and
// daff [B, 2, D] (with aff) per-block partials; ws: the wide plan's
// workspace, B slices of gnn_propagation_loop_bwd_workspace floats (null for
// a staged plan). Returns a cudaError_t code.
int gnn_propagation_loop_bwd(const float* adjT, const float* s0, const float* traj,
                             const float* fT, const float* w2, const float* aff,
                             const float* g_traj, float* gs, float* dw2, float* dfT,
                             float* daff, int B, int W, int D, int K, int act, void* stream,
                             float* ws) {
  if (!block_ok(B, W) || D <= 0 || K <= 0 || (aff != nullptr && daff == nullptr))
    return cudaErrorInvalidValue;
  LoopBwdPlan p;
  size_t bytes;
  int index, wsf;
  const LoopBwdFn fn = pick_bwd(W, D, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, fT, w2, aff, g_traj, gs, dw2, dfT, daff, B, W, D, K, act, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block gnn_propagation_loop_bwd's plan for this
// shape needs (0 for a staged plan), or -1 if no plan fits (AL and H1
// unused).
int gnn_propagation_loop_bwd_workspace(int W, int D, int AL, int H1) {
  (void)AL;
  (void)H1;
  LoopBwdPlan p;
  size_t bytes;
  int index, wsf;
  return pick_bwd(W, D, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_propagation_loop_bwd
// launches for this shape (AL and H1 unused). Returns a cudaError_t code.
int gnn_propagation_loop_bwd_info(int W, int D, int AL, int H1, int* out) {
  (void)AL;
  (void)H1;
  LoopBwdPlan p;
  size_t bytes;
  int index, wsf;
  const LoopBwdFn fn = pick_bwd(W, D, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` (kLoopBwdPlans, then the wide plan) from now on, where
// it fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_propagation_loop_bwd_force_plan(int index) { g_force = index; }

}  // extern "C"
