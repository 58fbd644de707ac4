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
// is CSR (ops/segment.py::build_agg_plan) and the op is a gather-sum:
//
// Design: one thread per (row, feature), consecutive threads on consecutive
// features of a row, so a warp reads state rows at consecutive addresses and
// every thread of a row reads the same (col, w) entries. A thread adds its
// row's entries in CSR order, each product rounded before the add (no fused
// multiply-add), so the sum is the plain version's sequential one on the CPU
// and a launch repeats bit for bit; no atomics. Every output element is
// written, a row without entries with 0, so the output needs no zeroing pass.
//
// Bound: a launch reads the state and the plan (rowptr, col and w of the
// arcs of nonzero weight) and writes the output; 2 flops an entry and
// feature. At the full MUTAG-shaped set (196,608 rows, 266,900 entries, D 14)
// that is ~25 MB, set by bytes. This first version reads (col, w) once per
// feature thread (through L1) and gathers source rows at random; a row with
// many entries serialises its threads (a hub).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_agg_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                   const float* __restrict__ w, const float* __restrict__ state,
                   float* __restrict__ out, int64_t N, int D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * D) return;
  const int64_t r = i / D;
  const int f = (int)(i - r * D);
  const int end = rowptr[r + 1];
  float acc = 0.0f;
  for (int e = rowptr[r]; e < end; ++e)
    acc = __fadd_rn(acc, __fmul_rn(w[e], state[(int64_t)col[e] * D + f]));
  out[i] = acc;
}

}  // namespace

extern "C" {

// rowptr [N + 1], col [nnz] int32, w [nnz] f32, state [N, D] f32 -> out
// [N, D] f32, every element written. Returns a cudaError_t code.
int gnn_segment_aggregate(const int* rowptr, const int* col, const float* w, const float* state,
                          float* out, int N, int D, void* stream) {
  if (N < 0 || D <= 0) return cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * D;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  segment_agg_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, w, state, out, (int64_t)N, D);
  return cudaGetLastError();
}

}  // extern "C"
