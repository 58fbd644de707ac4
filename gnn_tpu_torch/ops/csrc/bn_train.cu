// K2, the reverse of the BatchNorm-training iteration of a one-layer state
// net, for Hopper (sm_90a), in plain fp32 on the CUDA cores (no TF32, no bf16).
//
// Replaces gnn_tpu/ops/pallas_bn.py:
//   K2 _bn_bwd_kernel (launched by _bn_bwd_call) -> gnn_bn_backward
// Its forward, K1, is in bn_fwd.cu.
//
// A state net with a trailing BatchNorm couples every block each iteration
// through the batch moments, so one launch runs one reverse iteration over
// every block row, and [D]-sized glue (ops/bn.py) runs between launches.
// K2 is the reverse of K1 (x3 = [s | agg | feats] the dense input, w_aug =
// [Ws | Wa | Wf | b]) with the BatchNorm backward folded in from the [9, D]
// coefficient rows bnv (ops/bn.py::BNV_ROWS):
//   gy    = gamma_rstd * (ds_in + flag * gsel) - nm * (b2 + x_hat_k * c2)
//   dh    = gy * act'(h),  dw = dh^T @ [drop(x3); 1]   (per-block partial)
//   dagg  = (dh @ Wa) * dmask,  ds = (dh @ Ws) * dmask + adjT @ dagg
//   red   = (sum ds, sum ds * x_hat_prev)              (per-block partial)
// Sums over nodes leave as per-block partials that the caller adds up in
// order: no float atomics, so a result does not vary between runs.
//
// K2's design (one launch, every block row; tile2.cuh's staging and lists):
// - no resident adjacency: each row's nonzero entries go into a compact list
//   at staging ([16][W] weights and uint8 destinations, built from coalesced
//   16-byte reads of device memory, tile2.cuh::build_row_lists; a thread per
//   row reading its own row ran K2 at 0.34 ms, its list building the largest
//   phase); a row with more than 16 entries is read from device memory,
//   every entry, so a dense block is exact. ds = dxs + adjT @ dagg costs 2*D
//   an arc, not 2*D*W a node, and the adjacency is read once, which is the
//   bound;
// - the rows (y_prev, ds_in, gsel, y_k node-major by 16-byte copies; agg and
//   feats transposed into x3's rows), w_aug, bnv, nm and the keep bytes are
//   staged with cp.async, issued together and waited on once;
// - h is recomputed in the per-node kernel's order (bias first, then c
//   ascending), NT / W threads a node taking every
//   (NT / W)-th output;
// - dw = dh^T @ [x3; 1] is a block product over all threads on register
//   tiles (4 outputs x 4 columns a thread, 16-byte reads of the transposed
//   dh and x3), over 8 fixed node ranges whose sums are added in order
//   afterwards; red (sum ds, sum ds * x_hat_prev) likewise over 2D x 8
//   threads; no atomics, so a repeat launch is bit-identical, and every plan
//   gives the same bits;
// - without the resident 66 KB adjacency a CTA takes 69.6 KB at the
//   flagship's D 14, F 3: three CTAs of 256 threads an SM.
// The plans (kBnBwdPlans: threads, list room, rows staged) are mirrored by
// ops/bn.py::_bn_bwd_plan; the last (128 threads) stages no rows and reads
// the adjacency from device memory, and fits every shape the per-node kernel
// that this replaces took. Up to D 64 a thread's outputs fit its register
// arrays (16, 32 or 64 wide by D); above that the 64-wide instantiations run
// chunked: h and ds over JT outputs at a time, dx one output at a time from
// dh in shared memory, and dx's state slice parked in ds's output rows
// until ds is formed. So every plan takes any D its layout fits.
//
// The wide plan (index 2, 256 threads with the lists; mirrored by
// ops/bn.py::_bn_bwd_wide), chosen only where no staged plan fits, takes
// every D: x3, dh and the late region lie in a device-memory workspace the
// wrapper allocates (a block row's slice each, gnn_bn_backward_workspace
// floats), w_aug, bnv, the rows and the keep bytes are read through the
// caches, and shared memory holds only nm and the row lists (10,880 bytes at
// W 128, whatever D and F are). It runs chunked; a forced wide plan gives
// the staged plans' bits.
//
// Bound: a launch reads every block's adjacency (W*W*4 bytes, 64 KiB at
// W = 128) once, which dominates the bytes moved; the arcs present need
// 2*D flops each, and the dense layer 4*D*C per node, so the least time is
// set by bytes.

#include "tile2.cuh"

namespace {

using namespace gnn;

// A K2 plan: threads a CTA, room of the row lists (0: the adjacency is read
// from device memory), whether the rows and keep bytes are staged.
struct BnBwdPlan {
  int nt, E, st;
};

// 256 threads a CTA, three CTAs an SM at the flagship's widths: 0.142 ms on
// an NVIDIA H100 at the flagship's training batch, against 0.252 with the
// last plan, which fits every shape the per-node K2 took; the same plan with
// 128 threads ran 0.187 against 0.146 and was dropped, since no shape takes
// it that the first does not fit (PERF.md §6).
constexpr BnBwdPlan kBnBwdPlans[] = {{256, 16, 1}, {128, 0, 0}};
// the wide plan, after the staged ones
constexpr BnBwdPlan kBnBwdWide = {256, 16, 0};
constexpr int kBnBwdWideIndex = sizeof(kBnBwdPlans) / sizeof(kBnBwdPlans[0]);

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The dw and red sums over a block's nodes run over kNodeRanges fixed node
// ranges, each summed in node order, and the ranges' sums are added in
// order: the staged plans sum the ranges in parallel into partials, the last
// plan one range after another, so every plan gives the same bits.
constexpr int kNodeRanges = 8;

// Float offsets of K2's shared memory (bytes for the list counts and
// destinations, after the floats), each region a multiple of 16 bytes:
// x3 X [C1][W] (dropped, transposed), dh [D][W], w_aug transposed wT [C][D4]
// (D4 = D rounded up to 4, zero past D; its last row the bias), bnv [9][D],
// nm [W], with st y_prev [W][D] and the keep bytes [W][C1], a late region
// (with st: ds_in, gsel, y_k [W][D] each; then dagg [W][D|1] and the
// partials), the lists [E][W]. ds and ds * x_hat_prev [W][D|1] take X and dh
// once those are read. The wide plan: x3, dh and dagg in a block row's
// workspace slice of ws floats (ds and ds * x_hat_prev over x3 and dh as
// above); in shared memory nm and the lists, then the bytes.
struct BnBwdLayout {
  int x, dh, w, v, nm, yp, kp, di, gs, yk, da, part, lw, ds, dsx, ws;
  size_t cnt_b, idx_b, bytes;
};

__host__ __device__ inline BnBwdLayout bwd_layout(int W, int D, int F, const BnBwdPlan& p,
                                                  bool wide) {
  BnBwdLayout L{};
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1;
  int o = 0;
  if (wide) {
    L.x = o;
    o += round4(C1 * W);
    L.dh = o;
    o += round4(D * W);
    L.da = o;
    o += round4(W * DP);
    L.part = L.ws = o;
    L.ds = L.x;
    L.dsx = L.x + round4(W * DP);
    L.w = L.v = L.yp = L.kp = L.di = L.gs = L.yk = -1;
    o = 0;
    L.nm = o;
    o += round4(W);
    L.lw = o;
    o += p.E * W;
    L.cnt_b = sizeof(float) * (size_t)o;
    L.idx_b = L.cnt_b + W;
    L.bytes = L.idx_b + (size_t)p.E * W;
    return L;
  }
  L.x = o;
  o += round4(C1 * W);
  L.dh = o;
  o += round4(D * W);
  L.w = o;
  o += C * round4(D);
  L.v = o;
  o += round4(9 * D);
  L.nm = o;
  o += round4(W);
  L.yp = L.kp = -1;
  if (p.st) {
    L.yp = o;
    o += round4(W * D);
    L.kp = o;
    o += round4((W * C1 + 3) / 4);
  }
  L.di = o;
  L.gs = L.di + round4(W * D);
  L.yk = L.gs + round4(W * D);
  L.da = o;
  L.part = L.da + round4(W * DP);
  const int part = p.st ? kNodeRanges * D * C : 0;  // D * C >= 2D: red's partials fit
  o += max(p.st ? 3 * round4(W * D) : 0, round4(W * DP) + round4(part));
  L.lw = o;
  o += p.E * W;
  L.ds = L.x;
  L.dsx = L.x + round4(W * DP);
  L.cnt_b = sizeof(float) * (size_t)o;
  L.idx_b = L.cnt_b + (p.E ? W : 0);
  L.bytes = L.idx_b + (size_t)p.E * W;
  L.ws = 0;
  return L;
}

// K2: one reverse BN-training iteration over every block row, NT threads a
// CTA, one block row each; WIDE: the wide plan (ws its workspace).
template <int MAXF, int NT, bool ST, bool WIDE>
__global__ void __launch_bounds__(NT, NT == 256 ? 3 : 4)
bn_bwd_kernel(const float* __restrict__ adj_loop, const float* __restrict__ adj_dep,
              const float* __restrict__ y_prev, const float* __restrict__ y_k,
              const float* __restrict__ agg, const uint8_t* __restrict__ keep,
              const float* __restrict__ feats, const float* __restrict__ w_aug,
              const float* __restrict__ ds_in, const float* __restrict__ gsel,
              const float* __restrict__ bnv, const float* __restrict__ flag,
              const float* __restrict__ nm, float* __restrict__ ds, float* __restrict__ dw,
              float* __restrict__ dagg, float* __restrict__ red, int Bl, int W, int D, int F,
              int act, int mode, float da, float db, BnBwdPlan p, float* ws) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const BnBwdLayout L = bwd_layout(W, D, F, p, WIDE);
  const int C1 = 2 * D + F, C = C1 + 1, DP = D | 1;
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t row0 = (size_t)r * W;
  const float* adj = block_adj(adj_loop, adj_dep, Bl, W);
  float* base = WIDE ? ws + (size_t)r * L.ws : sm;  // the regions of x3, dh and dagg
  float* X = base + L.x;
  float* DH = base + L.dh;
  float* wT = sm + L.w;
  const float* v = WIDE ? bnv : sm + L.v;  // bnv rows, ops/bn.py::BNV_ROWS
  float* nms = sm + L.nm;
  float* DA = base + L.da;
  float* lw = sm + L.lw;
  uint8_t* cnt = reinterpret_cast<uint8_t*>(smem_raw) + L.cnt_b;
  uint8_t* idx = reinterpret_cast<uint8_t*>(smem_raw) + L.idx_b;
  // the block's rows, staged or in device memory
  const float* yp = ST ? sm + L.yp : y_prev + row0 * D;
  const float* di = ST ? sm + L.di : ds_in + row0 * D;
  const float* gs = ST ? sm + L.gs : gsel + row0 * D;
  const float* yk = ST ? sm + L.yk : y_k + row0 * D;
  const uint8_t* kg = mode != kNoDrop ? keep + row0 * C1 : nullptr;
  const uint8_t* kp = ST && kg != nullptr ? reinterpret_cast<const uint8_t*>(sm + L.kp) : kg;
  // thread (node n, part): NT / W threads a node (at W = 96 the last threads
  // take none), each taking columns c = part + tpn * i of x3 and a block of
  // JB outputs (or state columns) from j0 on, JB a multiple of 4, at most JT
  constexpr int JT = MAXF * kMaxW / NT;
  const int D4 = round4(D), tpn = NT / W, n = t % W, part = t / W;
  const bool mine = part < tpn;
  const int JB = round4((D + tpn - 1) / tpn), j0 = part * JB, j1 = min(D, j0 + JB);
  // above D 64 (and in the wide plan) a thread's outputs exceed the register
  // arrays: h and ds go JT outputs at a time, dx one output at a time
  const bool chunked = WIDE || (MAXF == 64 && D > MAXF);
  auto wcol = [&](int c, int j, float (&w)[4]) {  // w[u] = w_aug [j + u][c], zero past D
    if constexpr (WIDE) {
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = j + u < D ? w_aug[(size_t)(j + u) * C + c] : 0.0f;
    } else {
      ldv<4>(wT + c * D4 + j, w);
    }
  };

  // ---- staging, issued together, waited on once
  if constexpr (!WIDE) {
    // wT [c][j] = w_aug [j][c], in w_aug's order (whole rows of it a warp)
    for (int i = t; i < C * D4; i += NT) {
      const int j = i / C, c = i % C;
      if (j < D)
        cp_async4(wT + c * D4 + j, w_aug + i);
      else
        wT[c * D4 + j] = 0.0f;
    }
    for (int i = t; i < 9 * D; i += NT) cp_async4(sm + L.v + i, bnv + i);
  }
  cp_rows(nms, nm + row0, W);
  if constexpr (ST) {
    cp_rows(sm + L.yp, y_prev + row0 * D, W * D);
    cp_rows(sm + L.di, ds_in + row0 * D, W * D);
    cp_rows(sm + L.gs, gsel + row0 * D, W * D);
    cp_rows(sm + L.yk, y_k + row0 * D, W * D);
    stage_rowsT(agg + row0 * D, W, D, X, D);
    stage_rowsT(feats + row0 * F, W, F, X, 2 * D);
    if (kg != nullptr) {
      uint8_t* kd = reinterpret_cast<uint8_t*>(sm + L.kp);
      if (reinterpret_cast<uintptr_t>(kg) % 16 == 0) {  // W * C1 is a multiple of 32
        for (int i = 16 * t; i < W * C1; i += 16 * NT)
          cp_async16(reinterpret_cast<float*>(kd + i), reinterpret_cast<const float*>(kg + i));
      } else {
        for (int i = t; i < W * C1; i += NT) kd[i] = kg[i];
      }
    }
  }
  if (p.E > 0) build_row_lists(adj, W, p.E, lw, idx, cnt);
  cp_async_wait_all();
  __syncthreads();

  // ---- the forward's dropped x3, transposed: s_prev (rounded as the plain
  // version: multiply, then add), agg, feats
  for (int c = part; mine && c < C1; c += tpn) {
    float x;
    if (c < D)
      x = __fadd_rn(__fmul_rn(yp[n * D + c], v[c]), v[D + c]);
    else if (ST)
      x = X[c * W + n];
    else
      x = c < 2 * D ? agg[(row0 + n) * D + c - D] : feats[(row0 + n) * F + c - 2 * D];
    X[c * W + n] = drop(mode, da, db, x, kp != nullptr && kp[n * C1 + c] != 0);
  }
  __syncthreads();

  // ---- dh = gy * act'(h) for outputs jc + i, JT at a time from jc = j0
  // (one chunk up to D 64), h in the per-node order (bias first, then c
  // ascending; four outputs a 16-byte read of wT, wide: four rows of w_aug),
  // gy from the state cotangent and the BatchNorm backward coefficients
  for (int jc = j0; mine && jc < j1; jc += JT) {
    float h[JT];
#pragma unroll
    for (int q = 0; q < JT; q += 4) {
      float b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (jc + q < j1) wcol(C1, jc + q, b4);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[q + u] = b4[u];
    }
    for (int c = 0; c < C1; ++c) {
      const float x = X[c * W + n];
#pragma unroll
      for (int q = 0; q < JT; q += 4) {
        if (jc + q < j1) {
          float w4[4];
          wcol(c, jc + q, w4);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[q + u] = fmaf(w4[u], x, h[q + u]);
        }
      }
    }
    const float f = *flag, nmv = nms[n];
#pragma unroll
    for (int i = 0; i < JT; ++i) {
      const int j = jc + i;
      if (j < j1) {
        const int e = n * D + j;
        const float g = di[e] + f * gs[e];
        const float xk = (yk[e] - v[2 * D + j]) * v[3 * D + j];
        DH[j * W + n] = (v[4 * D + j] * g - nmv * (v[5 * D + j] + xk * v[6 * D + j])) *
                        act_grad(act, h[i]);
      }
    }
  }
  __syncthreads();

  // ---- dx = dh @ [Ws | Wa] through the dropout's derivative a * keep, for
  // state columns j0 + i, j ascending (four a 16-byte read of wT); dagg into
  // DA (the late region: ds_in, gsel and y_k are read). Chunked, one column
  // at a time from dh in shared memory (or the workspace), its state slice
  // parked in ds's output row, the same chains (zero terms past D included)
  float dxs[JT];
  if (chunked) {
    for (int d = j0; mine && d < j1; ++d) {
      float ss = 0.0f, sa = 0.0f;
      for (int q = 0; q < D; q += 4) {
        float ws4[4], wa4[4];
        wcol(d, q, ws4);
        wcol(D + d, q, wa4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float dhv = q + u < D ? DH[(q + u) * W + n] : 0.0f;
          ss = fmaf(dhv, ws4[u], ss);
          sa = fmaf(dhv, wa4[u], sa);
        }
      }
      ds[(row0 + n) * D + d] = ss * drop_grad(mode, da, kp != nullptr && kp[n * C1 + d] != 0);
      DA[n * DP + d] = sa * drop_grad(mode, da, kp != nullptr && kp[n * C1 + D + d] != 0);
    }
  } else {
    float dh[MAXF];
#pragma unroll
    for (int j = 0; j < MAXF; ++j) dh[j] = mine && j < D ? DH[j * W + n] : 0.0f;
#pragma unroll
    for (int i = 0; i < JT; ++i) {
      const int d = j0 + i;
      dxs[i] = 0.0f;
      if (mine && d < j1) {
        float ss = 0.0f, sa = 0.0f;
#pragma unroll
        for (int q = 0; q < MAXF; q += 4) {
          if (q < D) {
            float ws[4], wa[4];
            ldv<4>(wT + d * D4 + q, ws);
            ldv<4>(wT + (D + d) * D4 + q, wa);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              ss = fmaf(dh[q + u], ws[u], ss);
              sa = fmaf(dh[q + u], wa[u], sa);
            }
          }
        }
        dxs[i] = ss * drop_grad(mode, da, kp != nullptr && kp[n * C1 + d] != 0);
        DA[n * DP + d] = sa * drop_grad(mode, da, kp != nullptr && kp[n * C1 + D + d] != 0);
      }
    }
  }

  // ---- dw [D][C] = dh^T @ [x3 | 1] as a block product over the node
  // ranges: work item (quad of 4 outputs x 4 columns, node range sp) into the
  // partials, summed over the ranges in order below; without staging, item
  // (quad), the ranges in turn
  const int CQ = (C + 3) / 4, nq = ((D + 3) / 4) * CQ;
  const int nb = W / (4 * kNodeRanges);  // float4 node groups a range
  float* dw_r = dw + (size_t)r * D * C;
  float* part_s = sm + L.part;
  for (int wi = t; wi < nq * (ST ? kNodeRanges : 1); wi += NT) {
    const int qq = wi % nq, sp0 = ST ? wi / nq : 0;
    const int j0 = 4 * (qq / CQ), c0 = 4 * (qq % CQ);
    float acc[4][4], tot[4][4];
    for (int sp = sp0; sp < (ST ? sp0 + 1 : kNodeRanges); ++sp) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[u][i] = 0.0f;
      for (int bb = sp * nb; bb < (sp + 1) * nb; ++bb) {
        float hv[4][4], xv[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) ldv<4>(DH + min(j0 + u, D - 1) * W + 4 * bb, hv[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + i;
          if (c < C1) {
            ldv<4>(X + c * W + 4 * bb, xv[i]);
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m) xv[i][m] = 1.0f;  // the column of ones (or past C)
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[u][i] = fmaf(hv[u][m], xv[i][m], acc[u][i]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + u, c = c0 + i;
          if (ST) {
            if (j < D && c < C) part_s[(sp * D + j) * C + c] = acc[u][i];
          } else {
            tot[u][i] = sp == 0 ? acc[u][i] : tot[u][i] + acc[u][i];
            if (sp == kNodeRanges - 1 && j < D && c < C) dw_r[j * C + c] = tot[u][i];
          }
        }
      }
    }
  }
  __syncthreads();  // X and dh are read; DA and the dw partials are full

  if (ST)
    for (int o = t; o < D * C; o += NT) {
      float s = part_s[o];
      for (int sp = 1; sp < kNodeRanges; ++sp) s += part_s[sp * D * C + o];
      dw_r[o] = s;
    }
  // ---- ds = dxs + adjT @ dagg, row n's entries in order (each read once for
  // the block of columns; chunked, once for each JT columns), and
  // ds * x_hat_prev, into the freed X and dh
  float* DS = base + L.ds;
  float* DSX = base + L.dsx;
  for (int jc = j0; mine && jc < j1; jc += JT) {
    float acc[JT];
#pragma unroll
    for (int i = 0; i < JT; ++i) acc[i] = 0.0f;
    auto add = [&](float a, int m) {
#pragma unroll
      for (int i = 0; i < JT; ++i)
        if (jc + i < j1) acc[i] = fmaf(a, DA[m * DP + jc + i], acc[i]);
    };
    const int c = p.E > 0 ? cnt[n] : W + 1;
    if (c <= p.E) {
      for (int e = 0; e < c; ++e) add(lw[e * W + n], idx[e * W + n]);
    } else {
      for (int m = 0; m < W; ++m) add(adj[(size_t)n * W + m], m);
    }
#pragma unroll
    for (int i = 0; i < JT; ++i) {
      const int d = jc + i;
      if (d < j1) {
        const float s = (chunked ? ds[(row0 + n) * D + d] : dxs[i]) + acc[i];
        DS[n * DP + d] = s;
        DSX[n * DP + d] = s * ((yp[n * D + d] - v[7 * D + d]) * v[8 * D + d]);
      }
    }
  }
  __syncthreads();

  // ---- ds and dagg out; the next reverse step's reduction partials (sum ds,
  // sum ds * x_hat_prev) over the node ranges
  for (int i = t; i < W * D; i += NT) {
    const int m = i / D, d = i % D;
    ds[row0 * D + i] = DS[m * DP + d];
    dagg[row0 * D + i] = DA[m * DP + d];
  }
  const int nr = W / kNodeRanges;
  float* red_r = red + (size_t)r * 2 * D;
  for (int wi = t; wi < 2 * D * (ST ? kNodeRanges : 1); wi += NT) {
    const int o = wi % (2 * D), sp0 = ST ? wi / (2 * D) : 0;
    const float* col = (o < D ? DS + o : DSX + o - D);
    float tot = 0.0f;
    for (int sp = sp0; sp < (ST ? sp0 + 1 : kNodeRanges); ++sp) {
      float s = 0.0f;
      for (int m = sp * nr; m < (sp + 1) * nr; ++m) s += col[m * DP];
      if (ST)
        part_s[sp * 2 * D + o] = s;  // the dw partials are summed
      else
        tot = sp == 0 ? s : tot + s;
    }
    if (!ST) red_r[o] = tot;
  }
  if (ST) {
    __syncthreads();
    for (int o = t; o < 2 * D; o += NT) {
      float s = part_s[o];
      for (int sp = 1; sp < kNodeRanges; ++sp) s += part_s[sp * 2 * D + o];
      red_r[o] = s;
    }
  }
}

bool shape_ok(int R, int Bl, int W, int D, int F) {
  return R > 0 && Bl >= 0 && Bl <= R && W >= 32 && W <= kMaxW && W % 32 == 0 && D > 0 &&
         F >= 0;
}

int g_force = -1;  // gnn_bn_backward_force_plan

using BnBwdFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const uint8_t*, const float*, const float*, const float*, const float*,
                         const float*, const float*, const float*, float*, float*, float*,
                         float*, int, int, int, int, int, int, float, float, BnBwdPlan, float*);

template <int MAXF>
BnBwdFn bwd_variant(const BnBwdPlan& p) {
  return p.st ? bn_bwd_kernel<MAXF, 256, true, false> : bn_bwd_kernel<MAXF, 128, false, false>;
}

// K2's kernel and plan for a shape: the first plan of kBnBwdPlans that fits
// a CTA, else the wide plan (index kBnBwdWideIndex), or plan g_force (>= 0)
// if it fits; nullptr if none. The staged plans' register arrays are 16, 32
// or 64 wide by D (64 above it, chunked); *ws: the plan's workspace floats a
// block row.
BnBwdFn pick_bwd(int W, int D, int F, BnBwdPlan* p, size_t* bytes, int* index, int* ws) {
  *index = -1;
  for (int i = g_force >= 0 ? g_force : 0; i <= kBnBwdWideIndex; ++i) {
    const bool wide = i == kBnBwdWideIndex;
    const BnBwdPlan plan = wide ? kBnBwdWide : kBnBwdPlans[i];
    const BnBwdLayout L = bwd_layout(W, D, F, plan, wide);
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
  if (*index == kBnBwdWideIndex) return bn_bwd_kernel<64, 256, false, true>;
  return D <= 16 ? bwd_variant<16>(*p) : D <= 32 ? bwd_variant<32>(*p) : bwd_variant<64>(*p);
}

}  // namespace

extern "C" {

// As gnn_bn_forward, plus y_prev, y_k, agg, ds_in, gsel [R, W, D]; bnv [9, D];
// flag a device float (0 or 1) -> ds, dagg [R, W, D], dw [R, D, 2D + F + 1],
// red [R, 2, D]; ws: the wide plan's workspace, R slices of
// gnn_bn_backward_workspace floats (null for a staged plan). Returns a
// cudaError_t code.
int gnn_bn_backward(const float* adj_loop, const float* adj_dep, const float* y_prev,
                    const float* y_k, const float* agg, const uint8_t* keep, const float* feats,
                    const float* w_aug, const float* ds_in, const float* gsel, const float* bnv,
                    const float* flag, const float* nm, float* ds, float* dw, float* dagg,
                    float* red, int R, int Bl, int W, int D, int F, int act, int mode, float da,
                    float db, void* stream, float* ws) {
  if (!shape_ok(R, Bl, W, D, F)) return cudaErrorInvalidValue;
  if (mode != kNoDrop && keep == nullptr) return cudaErrorInvalidValue;
  BnBwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnBwdFn fn = pick_bwd(W, D, F, &p, &bytes, &index, &wsf);
  if (fn == nullptr || (wsf > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  fn<<<R, p.nt, bytes, static_cast<cudaStream_t>(stream)>>>(
      adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel, bnv, flag, nm, ds,
      dw, dagg, red, Bl, W, D, F, act, mode, da, db, p, ws);
  return cudaGetLastError();
}

// The workspace floats a block row gnn_bn_backward's plan for this shape
// needs (0 for a staged plan), or -1 if no plan fits (H1 unused).
int gnn_bn_backward_workspace(int W, int D, int F, int H1) {
  (void)H1;
  BnBwdPlan p;
  size_t bytes;
  int index, wsf;
  return pick_bwd(W, D, F, &p, &bytes, &index, &wsf) == nullptr ? -1 : wsf;
}

// out[0..4]: plan index, shared-memory bytes, resident CTAs an SM, registers
// a thread, local bytes a thread of the kernel gnn_bn_backward launches for
// this shape (H1 unused). Returns a cudaError_t code.
int gnn_bn_backward_info(int W, int D, int F, int H1, int* out) {
  (void)H1;
  BnBwdPlan p;
  size_t bytes;
  int index, wsf;
  const BnBwdFn fn = pick_bwd(W, D, F, &p, &bytes, &index, &wsf);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return tile_kernel_info(fn, bytes, index, out, p.nt);
}

// Launch plan `index` (kBnBwdPlans, then the wide plan) from now on, where it
// fits (a launch at a shape it does not fit fails), or the first plan that
// fits again (index -1): for timing one plan against another.
void gnn_bn_backward_force_plan(int index) { g_force = index; }

}  // extern "C"
