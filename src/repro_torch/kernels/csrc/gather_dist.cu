// gather_dist: out[b, j] = dist(q_b, vectors[clip(ids[b, j], 0, N-1)]),
// l2 or squared l2, for float32 rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_dist/
// gather_dist.py::gather_dist_pallas (grid (B, d), one scalar-prefetched
// row DMA per step).  Contract: kernels/gather_dist/ref.py.
//
// Bound on the H100: bytes.  Each (b, j) reads one m-float row at a random
// address and does 3m flops on it, far below the card's flop/byte ratio.
// Design: one warp per (b, j); the row and the query are read with
// coalesced 16-byte loads (m = 192 is 48 float4, no padding needed), the
// sum is kept in f32 and reduced with warp shuffles.  Rows are never
// staged in shared memory: each is used once.  Many warps in flight hide
// the gather latency.
#include "common.cuh"

namespace {

__global__ void gather_dist_kernel(const float* __restrict__ vectors,
                                   long long n_rows, int m,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ queries,
                                   float* __restrict__ out,
                                   long long n_pairs, int d, int squared,
                                   int vec4) {
  const long long pair =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // whole warp leaves together
  long long id = ids[pair];
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  const long long b = pair / d;
  const float s = repro::warp_sq_l2(vectors + id * m, queries + b * m, m,
                                    vec4 != 0, lane);
  if (lane == 0) out[pair] = repro::finish_dist(s, squared != 0);
}

}  // namespace

REPRO_EXPORT int gather_dist_f32(const void* vectors, long long n_rows, int m,
                                 const void* ids, const void* queries,
                                 void* out, int B, int d, int squared,
                                 void* stream) {
  const long long n_pairs = static_cast<long long>(B) * d;
  if (n_pairs == 0) return 0;
  const int vec4 = (m % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(vectors) |
                     reinterpret_cast<uintptr_t>(queries)) % 16 == 0);
  const int threads = 256;
  const long long blocks = (n_pairs * 32 + threads - 1) / threads;
  gather_dist_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), n_rows, m,
      static_cast<const int*>(ids), static_cast<const float*>(queries),
      static_cast<float*>(out), n_pairs, d, squared, vec4);
  return static_cast<int>(cudaGetLastError());
}
