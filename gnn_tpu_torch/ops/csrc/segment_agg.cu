// Segment aggregation over a CSR plan for Hopper (sm_90a), in plain fp32 on
// the CUDA cores: the state aggregation of a batch without blocks.
//
// Replaces gnn_tpu/ops/pallas_segment.py:
//   K18 _agg_kernel (launched by _run_plan) -> gnn_segment_aggregate
// and, on the transpose plan, its VJP (_ba_bwd).
//
//   out[r, f] = sum_{e = rowptr[r]}^{rowptr[r + 1] - 1} w[e] * state[col[e], f]
//
// The TPU kernel groups arcs into (destination block, source block) chunks
// and runs each as a one-hot gather and a weighted one-hot scatter on the
// matrix unit, zeroing an output block on its first visit (and needs
// zero-weight coverage chunks for blocks no arc reaches). Here the host plan
// is CSR (ops/segment.py::build_agg_plan) and the op is a gather-sum.
//
// Bound: a launch reads the state rows the plan names and the plan (rowptr,
// col and w of the arcs of nonzero weight) and writes the output; 2 flops an
// entry and feature. At the full MUTAG-shaped set (196,608 rows, 266,900
// entries, D 14) that is ~21 MB, set by bytes (0.0064 ms). A row's terms are
// one chain in CSR order, so a hub row of thousands of arcs is one lane's
// chain of dependent adds (splitting it would change the sums' order).
//
// Design: a group of L lanes takes a row, each lane V features at a time
// (float4 where D % 4 == 0, float2 where D % 2 == 0, else one float; L the
// least power of two that covers D / V vectors, at most 32, a lane looping
// over the rest), so a row's gathers are 16-, 8- or 4-byte reads by
// neighbouring lanes on neighbouring addresses. A lane reads its row's
// rowptr once, then the row's entries B at a time (8, or 4 with float4) and
// the rest four at a time: their (col, w) first (the group's lanes read the
// same addresses, one request a warp), then all the batch's gathers, then its
// terms added in CSR order, each product rounded before the add (__fmul_rn,
// __fadd_rn: no fused multiply-add); the row's last entry stands in for the
// entries past its end, whose terms are not added. The sum is the plain
// version's sequential one on the CPU, bit for bit the per-(row, feature)
// kernel this replaced, and a launch repeats bit for bit; no atomics, no
// barriers, no shuffles (broadcasting the entries by __shfl_sync within a
// group ran 0.0133 ms at D = 14 and 0.72 ms on a hub of 6000 arcs against
// 0.0118 and 0.43 on an NVIDIA H100, PERF.md §6). Every output element is
// written, a row without entries with 0, so the output needs no zeroing
// pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAggThreads = 256;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
};
template <>
struct Vec<2> {
  using type = float2;
};
template <>
struct Vec<4> {
  using type = float4;
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  const typename Vec<V>::type v = *reinterpret_cast<const typename Vec<V>::type*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = f[i];
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  typename Vec<V>::type v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = x[i];
  *reinterpret_cast<typename Vec<V>::type*>(p) = v;
}

// (vector width V, lanes a row L, rows a CTA, CTAs) of a launch over N rows
// of width D (ops/segment.py::_agg_launch mirrors it).
struct AggLaunch {
  int V, L, rows;
  int64_t ctas;
};

inline AggLaunch agg_launch(int64_t N, int D) {
  AggLaunch a{};
  a.V = D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1;
  const int nvec = D / a.V;
  a.L = 1;
  while (a.L < nvec && a.L < 32) a.L *= 2;
  a.rows = kAggThreads / a.L;
  a.ctas = (N + a.rows - 1) / a.rows;
  return a;
}

// acc += the B entries of a row from e0 (the last entry's index standing in
// past the row's end, its term not added): the entries' (col, w) read first,
// then every gather issued, then the terms added in CSR order.
template <int V, int B>
__device__ __forceinline__ void add_entries(const int* __restrict__ col,
                                            const float* __restrict__ w,
                                            const float* __restrict__ state, int D, int f0,
                                            int e0, int end, float (&acc)[V]) {
  int c[B];
  float wk[B], x[B][V];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int e = min(e0 + u, end - 1);
    c[u] = col[e];
    wk[u] = w[e];
  }
#pragma unroll
  for (int u = 0; u < B; ++u) load_vec<V>(state + (size_t)c[u] * D + f0, x[u]);
#pragma unroll
  for (int u = 0; u < B; ++u)
    if (e0 + u < end)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wk[u], x[u][i]));
}

template <int V>
__global__ void __launch_bounds__(kAggThreads)
segment_agg_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                   const float* __restrict__ w, const float* __restrict__ state,
                   float* __restrict__ out, int64_t N, int D, int L) {
  constexpr int B = V == 4 ? 4 : 8;
  const int g = threadIdx.x & (L - 1);
  const int64_t r = (int64_t)blockIdx.x * (kAggThreads / L) + threadIdx.x / L;
  if (r < N) {
    const int beg = rowptr[r], end = rowptr[r + 1], nvec = D / V;
    for (int v = g; v < nvec; v += L) {
      const int f0 = v * V;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      int e0 = beg;
      for (; e0 + B <= end; e0 += B) add_entries<V, B>(col, w, state, D, f0, e0, end, acc);
      for (; e0 < end; e0 += 4) add_entries<V, 4>(col, w, state, D, f0, e0, end, acc);
      store_vec<V>(out + (size_t)r * D + f0, acc);
    }
  }
}

template <int V>
cudaError_t launch(const AggLaunch& a, const int* rowptr, const int* col, const float* w,
                   const float* state, float* out, int N, int D, cudaStream_t stream) {
  segment_agg_kernel<V><<<(unsigned)a.ctas, kAggThreads, 0, stream>>>(rowptr, col, w, state, out,
                                                                      (int64_t)N, D, a.L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rowptr [N + 1], col [nnz] int32, w [nnz] f32, state [N, D] f32 (16-byte
// aligned) -> out [N, D] f32 (16-byte aligned), every element written.
// Returns a cudaError_t code.
int gnn_segment_aggregate(const int* rowptr, const int* col, const float* w, const float* state,
                          float* out, int N, int D, void* stream) {
  if (N < 0 || D <= 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const AggLaunch a = agg_launch(N, D);
  if (a.ctas > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.V) {
    case 4:
      return launch<4>(a, rowptr, col, w, state, out, N, D, st);
    case 2:
      return launch<2>(a, rowptr, col, w, state, out, N, D, st);
    default:
      return launch<1>(a, rowptr, col, w, state, out, N, D, st);
  }
}

// out[0..4]: vector width V, lanes a row L, rows a CTA, CTAs, registers a
// thread of the launch gnn_segment_aggregate makes over N rows of width D
// (the last two arguments unused). Returns a cudaError_t code.
int gnn_segment_aggregate_info(int N, int D, int, int, int* out) {
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  const AggLaunch a = agg_launch(N, D);
  auto* kernel = a.V == 4 ? segment_agg_kernel<4> : a.V == 2 ? segment_agg_kernel<2>
                                                             : segment_agg_kernel<1>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.V;
  out[1] = a.L;
  out[2] = a.rows;
  out[3] = static_cast<int>(a.ctas);
  out[4] = attr.numRegs;
  return cudaSuccess;
}

}  // extern "C"
