// K10_bf16, the two-layer eval loop on a bf16 block adjacency, for Hopper
// (sm_90a): all K iterations of residual-free blocks, gnn_tpu's hp = False
// rounding, on bf16 tensor-core tiles (mma_bf16.cuh).
//
// Replaces gnn_tpu/ops/pallas_fused.py:
//   K10 _loop2_kernel_T with a bf16 adjacency (hp false, launched by
//   _loop2_impl) -> gnn_propagation_loop2_bf16
// K9's bf16 variant is in fused2_bf16.cu, K11's in eval_loop2_bwd_bf16.cu;
// the f32 K10 in loop2.cu.
//
// One iteration on a block of W nodes (bf as in bf16.cuh):
//   U  = bf(s) @ bf(w20)^T                  [W, 2H1]
//   A  = adjT^T @ bf(U_a)                   the sources contracted
//   h0 = (U_s + A) + fT,  y0 = act0(h0)     act64: float64, rounded once
//   h1 = bf(y0) @ bf(w1)^T,  s' = act1(h1 + b1) * scale + shift
// Dataflow: gnn_tpu's. U_a is rounded before the aggregation (the rounding
// point chip_smoke.py::one_flip names "ua"); the f32 K10 aggregates the
// D-wide state first, this kernel the H1-wide bf(U_a) rows.
//
// Exactness: the aggregation A, the product of W*W*H1 multiply-adds an
// iteration that sets the kernel's work, runs on bf16 tensor-core tiles
// (mma_bf16.cuh). Its sums have a few nonzero terms a destination (the
// block's arcs), which on the sets served here are exact in f32 in any
// order. The dense layers' sums U (D terms) and h1 (H1 terms) are not: in
// another f32 order about 2^-14 of their bf16 roundings flip, and at the
// full set's 1440 blocks the flips compound over the K iterations past
// Part B's one-flip bound (tools/bf16_order.py). So U and h1 run on the
// CUDA cores in the plain version's order (the contracted index ascending,
// one f32 add a term; products of bf values are exact), and a launch gives
// the plain version's bits (ops/fused2.py::propagation_loop2_bf16_ref)
// wherever the tiles' sums are exact; it is held to it by Part B's gate.
// A repeat launch is bit-identical (no atomics, no split sums).
//
// Design: one CTA of W/16 warps a block, warp w owning the block's nodes
// 16w..16w+15. Shared memory holds the bf16 adjacency [W][W+8] (staged once
// a launch), bf(s) [W][Dp+8], bf(U_a) of a hidden chunk [W][HC+8], bf(y0)
// of the chunk [W][HC] and h1's sums [W][D] (Dp = D padded to 16; the row
// pads keep ldmatrix free of bank conflicts). HC is the widest multiple of
// 16, up to H1 padded, that leaves two CTAs an SM, else that fits one
// (loop2_bf16_layout; ops/fused2.py::loop2_bf16_layout mirrors it): at the
// h150 shapes (D 14, H1 150) two chunks, 128 and 32, 106 KiB a CTA. A chunk:
// each warp its rows of bf(U_a) (a thread two nodes and two units), a
// barrier, then each warp's 16-column groups of A on the tiles against
// every row, U_s (a lane the entries of A's fragments it holds) and fT
// added in the epilogue, act0, bf(y0) into shared memory, the warp's h1
// sums continued over the chunk's units (a thread two rows of a column), a
// barrier. bf(y0) takes act0 in f32 and falls back to float64 only near a
// bf16 rounding midpoint (bf16.cuh::bf_act64: the same bits as bf(act64)).
// The weights are rounded, zero-padded and transposed once a call by the
// wrapper (fused2.tile_bf16: bf(W0s)^T, bf(W0a)^T [Dp][H1p], bf(w1)^T
// [H1p][Dp]), so that a warp's lanes read adjacent weights: padded hidden
// units have zero weights and y0 = 0. The
// epilogue (b1, act1, the affine, the trajectory, the margins and the next
// bf(s)) touches only the warp's own rows.
//
// Bound: the bf16 adjacency read once (2*W*W bytes a block), s0, fT [W][H1]
// and the K states and margins; the operations 2*W*(2H1*D + W*H1 + H1*D) a
// block and iteration at the card's dense bf16 tensor-core rate
// (chip_smoke.py::bf16_bounds). The activations (W*H1 of them an
// iteration), the CUDA-core dense layers and fT's K reads stay outside that
// count.
//
// Margins: margins[k] = nm where the node moved before iteration k,
// ||s_k - s_{k-1}|| > thr * ||s_{k-1}||, s_{-1} = 1.

#include "bf16.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gnn;

constexpr int kLoop2Bf16MaxThreads = 256;

// The shared-memory layout: the hidden chunk and the bytes. Row strides
// (elements): the adjacency W + 8, bf(s) Dp + 8, bf(U_a) hc + 8, bf(y0) hc,
// h1 D.
struct Loop2Bf16Layout {
  int hc;
  size_t bytes;
};

constexpr long kTwoCtasBytes = 233472 / 2 - 1024;   // an SM's 228 KiB, two CTAs

Loop2Bf16Layout loop2_bf16_layout(int W, int D, int H1) {
  Loop2Bf16Layout L;
  const long fixed = 2L * W * (W + 8 + pad16(D) + 8 + 8) + 4L * W * D;
  long hc = (kTwoCtasBytes - fixed) / (4L * W) / 16 * 16;
  if (hc < 16) hc = (kMaxSmemBytes - fixed) / (4L * W) / 16 * 16;
  L.hc = static_cast<int>(hc < pad16(H1) ? hc : pad16(H1));
  L.bytes = fixed + 4 * (size_t)W * L.hc;
  return L;
}

__global__ void __launch_bounds__(kLoop2Bf16MaxThreads, 2)
loop2_bf16_kernel(const uint16_t* __restrict__ adjT, const float* __restrict__ s0,
                  const float* __restrict__ fT, const uint16_t* __restrict__ w20t,
                  const uint16_t* __restrict__ w1t, const float* __restrict__ b1,
                  const float* __restrict__ aff, const float* __restrict__ nm,
                  float* __restrict__ traj, float* __restrict__ marg, int B, int W, int D,
                  int H1, int K, float thr, int act0, int act1, Loop2Bf16Layout L) {
  extern __shared__ float4 smem_f4[];
  const int b = blockIdx.x, Dp = pad16(D), H1p = pad16(H1), HC = L.hc;
  const int AS = W + 8, SS = Dp + 8, US = HC + 8;   // row strides
  uint16_t* adj = reinterpret_cast<uint16_t*>(smem_f4);
  uint16_t* sb = adj + W * AS;
  uint16_t* ua = sb + W * SS;
  uint16_t* yb = ua + W * US;                       // bf(y0) [W][HC]
  float* h1 = reinterpret_cast<float*>(yb + W * HC);
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16, g = lane >> 2, q = lane & 3;
  const uint16_t* w0sT = w20t;                     // [Dp][H1p]: bf(W0s)^T
  const uint16_t* w0aT = w20t + (size_t)Dp * H1p;  // bf(W0a)^T

  stage_padded(adj, adjT + (size_t)b * W * W, W);
  for (int i = threadIdx.x; i < W * SS; i += blockDim.x) {
    const int r = i / SS, c = i % SS;
    sb[i] = c < D ? bf16_bits(s0[((size_t)b * W + r) * D + c]) : 0;
  }
  // margins[0]: s0 against ones
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    float dist = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float e = s0[((size_t)b * W + n) * D + d] - 1.0f;
      dist += e * e;
    }
    marg[(size_t)b * W + n] =
        sqrtf(dist) > thr * sqrtf((float)D) ? nm[(size_t)b * W + n] : 0.0f;
  }
  __syncthreads();

  const float* s_old = s0 + (size_t)b * W * D;   // s_k's rows of the block
  for (int k = 0; k < K; ++k) {
    for (int i = lane; i < 16 * D; i += 32) h1[m0 * D + i] = 0.0f;
    for (int c0 = 0; c0 < H1p; c0 += HC) {
      const int cw = min(HC, H1p - c0), units = min(cw, H1 - c0);
      // bf(U_a) of the chunk on the warp's rows, a thread the nodes n and
      // n + 8 and two units (the lanes' weight pairs side by side in W0a^T's
      // rows), each sum d ascending, one f32 add a term (exact products)
      for (int i = lane; i < 8 * (cw / 2); i += 32) {
        const int n = m0 + i / (cw / 2), h = 2 * (i % (cw / 2));
        float acc[4] = {};
        for (int d = 0; d < D; ++d) {
          const float s0v = bf16_value(sb[n * SS + d]), s1v = bf16_value(sb[(n + 8) * SS + d]);
          const uint32_t w =
              __ldg(reinterpret_cast<const uint32_t*>(w0aT + (size_t)d * H1p + c0 + h));
          const float wl = __uint_as_float(w << 16), wh = __uint_as_float(w & 0xffff0000u);
          acc[0] = fmaf(s0v, wl, acc[0]);
          acc[1] = fmaf(s0v, wh, acc[1]);
          acc[2] = fmaf(s1v, wl, acc[2]);
          acc[3] = fmaf(s1v, wh, acc[3]);
        }
        *reinterpret_cast<uint32_t*>(ua + n * US + h) = pack_bf16(acc[0], acc[1]);
        *reinterpret_cast<uint32_t*>(ua + (n + 8) * US + h) = pack_bf16(acc[2], acc[3]);
      }
      __syncthreads();   // every row of bf(U_a)
      for (int j = 0; j < cw; j += 16) {
        float A[2][4] = {}, us[2][4] = {};
        for (int ks = 0; ks < W; ks += 16) {   // A = adjT^T @ bf(U_a), the sources
          uint32_t a[4], bb[4];
          lda_cols(a, adj, AS, m0, ks);
          ldb_rows(bb, ua, US, ks, j);
          mma_bf16(A[0], a, bb[0], bb[1]);
          mma_bf16(A[1], a, bb[2], bb[3]);
        }
        // U_s at the lane's entries of A's fragments, d ascending
        for (int d = 0; d < D; ++d) {
          const float s0v = bf16_value(sb[(m0 + g) * SS + d]);
          const float s1v = bf16_value(sb[(m0 + g + 8) * SS + d]);
          const uint16_t* wr = w0sT + (size_t)d * H1p + c0 + j + 2 * q;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(wr + 8 * t));
            const float wl = __uint_as_float(w << 16), wh = __uint_as_float(w & 0xffff0000u);
            us[t][0] = fmaf(s0v, wl, us[t][0]);
            us[t][1] = fmaf(s0v, wh, us[t][1]);
            us[t][2] = fmaf(s1v, wl, us[t][2]);
            us[t][3] = fmaf(s1v, wh, us[t][3]);
          }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m0 + c_row(e), col = j + 8 * t + c_col(e), h = c0 + col;
            float y = 0.0f;
            if (h < H1) {
              y = bf_act64(act0, __fadd_rn(__fadd_rn(us[t][e], A[t][e]),
                                           __ldg(fT + ((size_t)b * W + r) * H1 + h)));
            }
            yb[r * HC + col] = static_cast<uint16_t>(__float_as_uint(y) >> 16);
          }
        }
      }
      __syncwarp();
      // h1 += bf(y0) . bf(w1) over the chunk's units ascending, a thread the
      // rows r and r + 8 of a column (the lanes' weights side by side in
      // w1^T's rows)
      for (int i = lane; i < 8 * D; i += 32) {
        const int r = m0 + i / D, d = i % D;
        const uint16_t* w = w1t + (size_t)c0 * Dp + d;
        float acc0 = h1[r * D + d], acc1 = h1[(r + 8) * D + d];
        for (int u = 0; u < units; ++u) {
          const float wv = bf16_value(__ldg(w + (size_t)u * Dp));
          acc0 = fmaf(bf16_value(yb[r * HC + u]), wv, acc0);
          acc1 = fmaf(bf16_value(yb[(r + 8) * HC + u]), wv, acc1);
        }
        h1[r * D + d] = acc0;
        h1[(r + 8) * D + d] = acc1;
      }
      __syncthreads();   // the chunk's bf(U_a) read by every warp
    }
    // epilogue on the warp's rows: s' = act1(h1 + b1) * scale + shift
    float* out = traj + ((size_t)k * B + b) * W * D;
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = m0 + i / D, d = i % D;
      const float h = __fadd_rn(h1[r * D + d], __ldg(b1 + d));
      const float v = __fadd_rn(__fmul_rn(act64(act1, h), __ldg(aff + d)), __ldg(aff + D + d));
      h1[r * D + d] = v;
      out[r * D + d] = v;
    }
    __syncwarp();
    if (k + 1 < K && lane < 16) {
      const int n = m0 + lane;
      float dist = 0.0f, norm = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float o = s_old[n * D + d], e = h1[n * D + d] - o;
        dist += e * e;
        norm += o * o;
      }
      marg[((size_t)(k + 1) * B + b) * W + n] =
          sqrtf(dist) > thr * sqrtf(norm) ? nm[(size_t)b * W + n] : 0.0f;
    }
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = m0 + i / D, d = i % D;
      sb[r * SS + d] = bf16_bits(h1[r * D + d]);
    }
    __syncwarp();
    s_old = out;
  }
}

}  // namespace

extern "C" {

// adjT bf16 [B, W, W], s0 [B, W, D], fT [B, W, H1], w20t bf16 [2, Dp, H1p]
// (bf(W0s)^T and bf(W0a)^T zero-padded), w1t bf16 [H1p, Dp] (bf(w1)^T
// zero-padded; Dp, H1p: D, H1 up to a multiple of 16), b1 [D], aff [2, D], nm [B, W] ->
// traj [K, B, W, D], marg [K, B, W]. Returns a cudaError_t code.
int gnn_propagation_loop2_bf16(const uint16_t* adjT, const float* s0, const float* fT,
                               const uint16_t* w20t, const uint16_t* w1t, const float* b1,
                               const float* aff, const float* nm, float* traj, float* marg,
                               int B, int W, int D, int H1, int K, float thr, int act0, int act1,
                               void* stream) {
  if (!block_ok(B, W) || D <= 0 || H1 <= 0 || K <= 0) return cudaErrorInvalidValue;
  const Loop2Bf16Layout L = loop2_bf16_layout(W, D, H1);
  if (L.hc < 16) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(loop2_bf16_kernel, L.bytes);
  if (err != cudaSuccess) return err;
  loop2_bf16_kernel<<<B, 2 * W, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      adjT, s0, fT, w20t, w1t, b1, aff, nm, traj, marg, B, W, D, H1, K, thr, act0, act1, L);
  return cudaGetLastError();
}

}  // extern "C"
