// K8, the reverse of the one-layer dropout-training loop, for Hopper
// (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K8 _loop_train_bwd_kernel (launched by _loop_train_bwd_impl) -> gnn_train_loop_bwd
// Its forward, K7, is in train_loop.cu.
//
// The K reverse iterations of K7 on one W-node block (H == D); reverse step
// k, from the saved state traj[k-1] (s0) and pre-dropout aggregation agg[k]:
//   x2  = [drop(s, ms[k]) | drop(agg[k], ma[k])],  h = w_cat @ x2 + fT[k]
//   dh  = (g_traj[k] + gs) * act'(h)        -> dfT[k];  dw += dh^T @ x2
//   dx2 = dh @ w_cat,  dagg = dx2[D:] * a*ma,  gs = dx2[:D] * a*ms + adjT @ dagg
//
// Bound: a launch reads the block's adjacency (64 KiB at W = 128) once and
// streams K per-step rows (traj, agg, fT, g_traj, two keep-byte rows) and
// writes dfT; the dense layers cost 12*D*D flops a node and step and the
// arcs present 2*D each, so the least time is set by bytes (chip_smoke.py::
// bnfree_bounds: 0.089 ms on the training batch's 1104 loop rows, K = 5).
//
// Design (K2's lists, K13's partials), one CTA of 256 threads a block:
// - no resident adjacency: the block's row lists ([16][W] weights and uint8
//   destinations, tile2.cuh::build_row_lists, from coalesced 16-byte reads)
//   are built once a launch and kept for all K reverse steps; a row with
//   more than 16 entries is read from device memory, every entry, so a dense
//   block is exact. gs costs 2*D an arc, not 2*D*W a node;
// - x2 lies transposed in shared memory ([2D][W], its keep bytes beside it),
//   dh transposed beside it ([D][W + 4]), so the dw sums are block products
//   over the node dimension by 16-byte reads, each thread owning a unit and
//   two columns, the 8 units a quarter-warp reads in 8 distinct bank groups;
// - h (recomputed in K7's order, train_loop.cu: c ascending from 0, then
//   + fT), dh, dx2 (j ascending) and gs (the dst order of the row sums,
//   then + dx2's state slice) on 256 / W threads a node, four outputs at a
//   time (a 16-byte read of the transposed w_cat); no register array is
//   wider than four (K2's per-node arrays, up to 64 wide and unrolled inside
//   the K loop, kept ptxas busy for many minutes); gs and dx2's state slice
//   wait in a node-major row buffer;
// - each dw entry is one chain over the block's nodes in order a step, added
//   to a partial kept in shared memory across the K steps (in device memory
//   with the second plan) and written once a launch;
// - the rows of a step are read from device memory where they are used: at
//   three CTAs an SM the other CTAs' work hides the reads (a plan that
//   prefetched them with cp.async held two CTAs an SM and was slower).
// So gs, dw and dfT are bit for bit the per-node kernel's: the same sums in
// the same orders. No atomics: a repeat launch is bit-identical and every
// plan gives the same bits. At W 128, D 14 a CTA of plan 0 takes 54,400
// bytes. The plans (kTrainBwdPlans: where the dw partials are kept) are
// mirrored by ops/fused.py::_train_bwd_plan; the second fits every shape the
// per-node kernel that this replaces took.
//
// The wide plan (index 2, the second plan with its [W][D]-sized regions
// moved out of shared memory; mirrored by ops/fused.py::_train_bwd_wide),
// chosen only where no staged plan fits, takes every D: x2, dh, dagg, the
// row buffer and the keep bytes lie in a device-memory workspace the wrapper
// allocates (a block's slice each, gnn_train_loop_bwd_workspace floats),
// w_cat is read through the caches, the dw partials are summed in their
// output, and shared memory holds only the row lists (10,368 bytes at
// W 128, whatever D is). The code is the second plan's with those pointers:
// a forced wide plan gives the staged plans' bits.

#include "tile2.cuh"

namespace {

using namespace gnn;

// A K8 plan: whether the dw partials are kept in shared memory (else in
// device memory).
struct TrainBwdPlan {
  int dw;
};

// The first plan runs three CTAs of 256 threads an SM at the flagship's
// widths (54,400 bytes); the second fits every shape the per-node K8 took.
// A plan that also prefetched the next step's rows with cp.async (86,656
// bytes, two CTAs an SM) ran 0.344 ms against 0.297 on an NVIDIA H100 at the
// flagship's training batch and was dropped (PERF.md §6).
constexpr TrainBwdPlan kTrainBwdPlans[] = {{1}, {0}};
// the wide plan, after the staged ones: the second plan's regions in the
// workspace
constexpr TrainBwdPlan kTrainBwdWide = {0};
constexpr int kTrainBwdWideIndex = sizeof(kTrainBwdPlans) / sizeof(kTrainBwdPlans[0]);
constexpr int kListRoom = 16;  // entries a row list holds

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Float offsets of K8's shared memory (bytes after the floats), each region
// a multiple of 16 bytes: x2 X [2D][W] (dropped, transposed), dh G [D][W + 4],
// dagg [W][D | 1], a node-major row buffer O [W][D | 1] (gs, then dx2's
// state slice, then the new gs), w_cat transposed wT [2D][D4] (D4 = D
// rounded up to 4, zero past D), with dw the partials [D][2D], the lists
// [16][W]; then the keep bytes [2][D][W] (transposed), the list counts [W]
// and destinations [16][W]. The wide plan: x2, dh, dagg, the row buffer and
// the keep bytes (from float offset km) in a block's workspace slice of ws
// floats; in shared memory the lists, then their counts and destinations.
struct TrainBwdLayout {
  int x, g, da, o, w, dw, lw, km, ws;
  size_t km_b, cnt_b, idx_b, bytes;
};

__host__ __device__ inline TrainBwdLayout bwd_layout(int W, int D, const TrainBwdPlan& p,
                                                     bool wide) {
  TrainBwdLayout L{};
  int o = 0;
  if (wide) {
    L.x = o;
    o += 2 * D * W;
    L.g = o;
    o += D * (W + 4);
    L.da = o;
    o += round4(W * (D | 1));
    L.o = o;
    o += round4(W * (D | 1));
    L.km = o;
    o += round4((2 * W * D + 3) / 4);
    L.ws = o;
    L.w = L.dw = -1;
    L.km_b = 0;
    o = 0;
    L.lw = o;
    o += kListRoom * W;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.bytes = L.idx_b + (size_t)kListRoom * W;
    return L;
  }
  L.x = o;
  o += 2 * D * W;
  L.g = o;
  o += D * (W + 4);
  L.da = o;
  o += round4(W * (D | 1));
  L.o = o;
  o += round4(W * (D | 1));
  L.w = o;
  o += 2 * D * round4(D);
  L.dw = -1;
  if (p.dw) {
    L.dw = o;
    o += round4(2 * D * D);
  }
  L.lw = o;
  o += kListRoom * W;
  L.km_b = sizeof(float) * (size_t)o;
  L.cnt_b = L.km_b + 2 * (size_t)W * D;
  L.idx_b = L.cnt_b + W;
  L.bytes = L.idx_b + (size_t)kListRoom * W;
  L.km = -1;
  L.ws = 0;
  return L;
}

// K8: the K reverse iterations of K7, one CTA of NT threads a block; WIDE:
// the wide plan (wsp its workspace).
constexpr int NT = kTileThreads;

template <bool WIDE>
__global__ void __launch_bounds__(NT, 3)
train_bwd_kernel(const float* __restrict__ adjT, const float* __restrict__ s0,
                 const float* __restrict__ traj, const float* __restrict__ agg,
                 const uint8_t* __restrict__ ms, const uint8_t* __restrict__ ma,
                 const float* __restrict__ fT, const float* __restrict__ w_cat,
                 const float* __restrict__ g_traj, float* __restrict__ gs_out,
                 float* __restrict__ dw_out, float* __restrict__ dfT, int B, int W, int D, int K,
                 int act, int mode, float da, float db, TrainBwdPlan p, float* wsp) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem_raw);
  const TrainBwdLayout L = bwd_layout(W, D, p, WIDE);
  const int C2 = 2 * D, DP = D | 1, GP = W + 4, D4 = round4(D), WD = W * D;
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  const float* adj = adjT + row0 * W;
  float* base = WIDE ? wsp + (size_t)b * L.ws : sm;  // the regions of x2 .. the row buffer
  float* X = base + L.x;
  float* G = base + L.g;
  float* DA = base + L.da;
  float* O = base + L.o;
  float* wT = sm + L.w;
  float* DW = sm + L.dw;
  float* lw = sm + L.lw;
  // [D][W] keep bytes of the state slice, then of agg
  uint8_t* KS = WIDE ? reinterpret_cast<uint8_t*>(base + L.km) : bytes + L.km_b;
  uint8_t* KA = KS + WD;
  uint8_t* cnt = bytes + L.cnt_b;
  uint8_t* idx = bytes + L.idx_b;
  float* dw_b = dw_out + (size_t)b * D * C2;
  const bool dropping = mode != kNoDrop;

  // step k's rows: s_in, agg, fT, g [W][D]
  auto rows = [&](int k, int which) -> const float* {
    const size_t kb = (size_t)k * B + b;
    switch (which) {
      case 0:
        return k > 0 ? traj + ((size_t)(k - 1) * B + b) * WD : s0 + row0 * D;
      case 1:
        return agg + kb * WD;
      case 2:
        return fT + kb * WD;
      default:
        return g_traj + kb * WD;
    }
  };

  // thread (node n, part): NT / W threads a node (at W = 96 the last threads
  // take none), each taking every (NT / W)-th quad of outputs (and of state
  // columns), the same quads in every phase
  const int tpn = NT / W, n = t % W, part = t / W;
  // dw items: unit j, columns c0, c0 + 1 (C2 is even)
  const int nitems = D * D;

  // w[u] = w_cat [j + u][c], zero past D: wT's row c (wide: read through the
  // caches)
  auto wt4 = [&](int c, int j, float (&w)[4]) {
    if constexpr (WIDE) {
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = j + u < D ? w_cat[(size_t)(j + u) * C2 + c] : 0.0f;
    } else {
      ldv<4>(wT + c * D4 + j, w);
    }
  };

  // ---- staging, issued together, waited on once
  // wT [c][j] = w_cat [j][c], in w_cat's order (whole rows of it a warp)
  for (int i = t; !WIDE && i < C2 * D4; i += NT) {
    const int j = i / C2, c = i % C2;
    if (j < D)
      cp_async4(wT + c * D4 + j, w_cat + i);
    else
      wT[c * D4 + j] = 0.0f;
  }
  for (int i = t; i < W * DP; i += NT) O[i] = 0.0f;  // gs = 0 before the last step
  for (int wi = t; wi < nitems; wi += NT) {  // each entry owned by this thread from here on
    const int j = wi % D, c0 = 2 * (wi / D);
    for (int i = 0; i < 2; ++i) {
      if (p.dw)
        DW[j * C2 + c0 + i] = 0.0f;
      else
        dw_b[j * C2 + c0 + i] = 0.0f;
    }
  }
  build_row_lists(adj, W, kListRoom, lw, idx, cnt);
  cp_async_wait_all();
  __syncthreads();

  for (int k = K - 1; k >= 0; --k) {
    const size_t kb = (size_t)k * B + b;
    // ---- x2 as K7 formed it, transposed into X; the keep bytes beside it
    // (consecutive threads take consecutive nodes: conflict-free stores)
    {
      const float* rs = rows(k, 0);
      const float* ra = rows(k, 1);
      const uint8_t* ks = dropping ? ms + kb * WD : nullptr;
      const uint8_t* ka = dropping ? ma + kb * WD : nullptr;
      for (int i = t; i < WD; i += NT) {
        const int d = i / W, m = i % W, e = m * D + d;
        const bool bs = ks != nullptr && ks[e] != 0, ba = ka != nullptr && ka[e] != 0;
        X[i] = drop(mode, da, db, rs[e], bs);
        X[WD + i] = drop(mode, da, db, ra[e], ba);
        KS[i] = bs;
        KA[i] = ba;
      }
    }
    __syncthreads();

    // ---- h as K7 formed it (the dense sum from 0, c ascending, then fT[k]),
    // dh = (g_traj[k] + gs) * act'(h) into G (transposed) and out as dfT[k],
    // four outputs of node n at a time (a 16-byte read of wT)
    if (part < tpn) {
      const float* rf = rows(k, 2);
      const float* rg = rows(k, 3);
      for (int j0 = 4 * part; j0 < D; j0 += 4 * tpn) {
        float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c = 0; c < C2; ++c) {
          const float x = X[c * W + n];
          float w4[4];
          wt4(c, j0, w4);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[u] = fmaf(w4[u], x, h[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < D) {
            const float dh =
                (rg[n * D + j] + O[n * DP + j]) * act_grad(act, h[u] + rf[n * D + j]);
            G[j * GP + n] = dh;
            dfT[(kb * W + n) * D + j] = dh;
          }
        }
      }
    }
    __syncthreads();  // G holds every node's dh

    // ---- dx2 = dh @ w_cat through the dropout's derivative a * keep, four
    // state columns of node n at a time, j ascending (four a 16-byte read of
    // wT): the state slice into O (over gs, read above), dagg into DA
    if (part < tpn) {
      for (int d0 = 4 * part; d0 < D; d0 += 4 * tpn) {
        float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = 0; q < D; q += 4) {
          float dh[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) dh[u] = q + u < D ? G[(q + u) * GP + n] : 0.0f;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (d0 + v < D) {
              float ws[4], wa[4];
              wt4(d0 + v, q, ws);
              wt4(D + d0 + v, q, wa);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                ss[v] = fmaf(dh[u], ws[u], ss[v]);
                sa[v] = fmaf(dh[u], wa[u], sa[v]);
              }
            }
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int d = d0 + v;
          if (d < D) {
            if (dropping) {
              ss[v] *= drop_grad(mode, da, KS[d * W + n] != 0);
              sa[v] *= drop_grad(mode, da, KA[d * W + n] != 0);
            }
            O[n * DP + d] = ss[v];
            DA[n * DP + d] = sa[v];
          }
        }
      }
    }
    __syncthreads();  // DA holds every node's dagg

    // ---- gs = dx2[:D] * a*ms + adjT @ dagg into O, four columns at a time,
    // row n's entries in order
    if (part < tpn) {
      const int c = cnt[n];
      for (int d0 = 4 * part; d0 < D; d0 += 4 * tpn) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        auto add = [&](float a, int m) {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (d0 + v < D) acc[v] = fmaf(a, DA[m * DP + d0 + v], acc[v]);
        };
        if (c <= kListRoom) {
          for (int e = 0; e < c; ++e) add(lw[e * W + n], idx[e * W + n]);
        } else {
          for (int m = 0; m < W; ++m) add(adj[(size_t)n * W + m], m);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (d0 + v < D) O[n * DP + d0 + v] += acc[v];
      }
    }
    // ---- dw[j][c] += sum over the block's nodes in order of dh[n][j] *
    // x2[n][c], one chain an entry, four nodes a 16-byte read
    for (int wi = t; wi < nitems; wi += NT) {
      const int j = wi % D, c0 = 2 * (wi / D);
      float a0 = 0.0f, a1 = 0.0f;
      for (int bb = 0; bb < W / 4; ++bb) {
        float hv[4], x0[4], x1[4];
        ldv<4>(G + j * GP + 4 * bb, hv);
        ldv<4>(X + c0 * W + 4 * bb, x0);
        ldv<4>(X + (c0 + 1) * W + 4 * bb, x1);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          a0 = fmaf(hv[m], x0[m], a0);
          a1 = fmaf(hv[m], x1[m], a1);
        }
      }
      float* dst = p.dw ? DW + j * C2 + c0 : dw_b + j * C2 + c0;
      dst[0] += a0;
      dst[1] += a1;
    }
    __syncthreads();  // X, G and DA are rewritten by the next step
  }

  // ---- gs and the dw partials out
  for (int i = t; i < WD; i += NT) gs_out[row0 * D + i] = O[(i / D) * DP + i % D];
  if (p.dw)
    for (int i = t; i < D * C2; i += NT) dw_b[i] = DW[i];
}

int g_force = -1;  // gnn_train_loop_bwd_force_plan

using TrainBwdFn = void (*)(const float*, const float*, const float*, const float*,
                            const uint8_t*, const uint8_t*, const float*, const float*,
                            const float*, float*, float*, float*, int, int, int, int, int, int,
                            float, float, TrainBwdPlan, float*);

// K8's kernel and plan for a shape: the first plan of kTrainBwdPlans that
// fits a CTA, else the wide plan (index kTrainBwdWideIndex), or plan g_force
// (>= 0) if it fits; nullptr if none. *ws: the plan's workspace floats a
// block.
TrainBwdFn pick_bwd(int W, int D, TrainBwdPlan* p, size_t* bytes, int* index, int* ws) {
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i <= kTrainBwdWideIndex; ++i) {
    const bool wide = i == kTrainBwdWideIndex;
    const TrainBwdPlan plan = wide ? kTrainBwdWide : kTrainBwdPlans[i];
    const TrainBwdLayout L = bwd_layout(W, D, plan, wide);
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
  return *index == kTrainBwdWideIndex ? train_bwd_kernel<true> : train_bwd_kernel<false>;
}

}  // namespace

extern "C" {

// adjT [B, W, W], s0 [B, W, D], traj, agg, fT, g_traj [K, B, W, D], ms/ma
// uint8 [K, B, W, D] (null when mode == 0), w_cat [D, 2D] -> gs [B, W, D],
// dw [B, D, 2D] per-block partials, dfT [K, B, W, D]; ws: the wide plan's
// workspace, B slices of gnn_train_loop_bwd_workspace floats (null for a
// staged plan). Returns a cudaError_t code.
int gnn_train_loop_bwd(const float* adjT, const float* s0, const float* traj, const float* agg,
                       const uint8_t* ms, const uint8_t* ma, const float* fT,
                       const float* w_cat, const float* g_traj, float* gs, float* dw,
                       float* dfT, int B, int W, int D, int K, int act, int mode, float da,
                       float db, void* stream, float* ws) {
  if (!block_ok(B, W) || D <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (mode != kNoDrop && (ms == nullptr || ma == nullptr)) return cudaErrorInvalidValue;
  TrainBwdPlan p;
  size_t bytes;
  int index, wsf;
  const TrainBwdFn fn = pick_bwd(W, D, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj, gs, dw, dfT, B, W, D, K, act, mode, da,
      db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block gnn_train_loop_bwd's plan for this shape
// needs (0 for a staged plan), or -1 if no plan fits (AL and H1 unused).
int gnn_train_loop_bwd_workspace(int W, int D, int AL, int H1) {
  (void)AL;
  (void)H1;
  TrainBwdPlan p;
  size_t bytes;
  int index, wsf;
  return pick_bwd(W, D, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_train_loop_bwd launches
// for this shape (AL, H1 unused). Returns a cudaError_t code.
int gnn_train_loop_bwd_info(int W, int D, int AL, int H1, int* out) {
  (void)AL;
  (void)H1;
  TrainBwdPlan p;
  size_t bytes;
  int index, wsf;
  const TrainBwdFn fn = pick_bwd(W, D, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out);
}

// Launch plan `index` (kTrainBwdPlans, then the wide plan) from now on,
// where it fits (a launch at a shape it does not fit fails), or the first
// plan that fits again (index -1): for timing one plan against another.
void gnn_train_loop_bwd_force_plan(int index) { g_force = index; }

}  // extern "C"
