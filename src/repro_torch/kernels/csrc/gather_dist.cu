// gather_dist: out[b, j] = dist(q_b, vectors[clip(ids[b, j], 0, N-1)]),
// l2 or squared l2, for float32, fp16 or bf16 rows and float32 queries.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_dist/
// gather_dist.py::gather_dist_pallas (grid (B, d), one scalar-prefetched
// row DMA per step; fp16 and bf16 rows stay half width on the way in and
// are upcast per tile).  Contract: kernels/gather_dist/ref.py.
//
// Bound on the H100: bytes.  Each (b, j) reads one m-element row at a
// random address and does 3m flops on it, far below the card's flop/byte
// ratio.  Design: one warp per (b, j); the row and the query are read with
// coalesced 16-byte loads (4 floats, or 8 halves against two float4 of
// the query; m = 192 needs no padding), half rows are converted in
// registers through the cuda_fp16 / cuda_bf16 intrinsics, the sum is kept
// in f32 and reduced with warp shuffles.  Rows are never staged in shared
// memory: each is used once.  Many warps in flight hide the gather
// latency.  The float32 row of a half store never reaches device memory.
#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_dist_kernel(const T* __restrict__ vectors,
                                   long long n_rows, int m,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ queries,
                                   float* __restrict__ out,
                                   long long n_pairs, int d, int squared,
                                   int vec) {
  const long long pair =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // whole warp leaves together
  long long id = ids[pair];
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  const long long b = pair / d;
  const float s = repro::row_sq_l2<false>(vectors + id * m, queries + b * m,
                                          m, vec != 0, lane);
  if (lane == 0) out[pair] = repro::finish_dist(s, squared != 0);
}

template <typename T>
int launch(const void* vectors, long long n_rows, int m, const void* ids,
           const void* queries, void* out, int B, int d, int squared,
           void* stream) {
  const long long n_pairs = static_cast<long long>(B) * d;
  if (n_pairs == 0) return 0;
  const int vec = (m % repro::per_load<T>() == 0) &&
                  ((reinterpret_cast<uintptr_t>(vectors) |
                    reinterpret_cast<uintptr_t>(queries)) % 16 == 0);
  const int threads = 256;
  const long long blocks = (n_pairs * 32 + threads - 1) / threads;
  gather_dist_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vectors), n_rows, m,
      static_cast<const int*>(ids), static_cast<const float*>(queries),
      static_cast<float*>(out), n_pairs, d, squared, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GATHER_DIST_ENTRY(NAME, T)                                          \
  REPRO_EXPORT int NAME(const void* vectors, long long n_rows, int m,       \
                        const void* ids, const void* queries, void* out,    \
                        int B, int d, int squared, void* stream) {          \
    return launch<T>(vectors, n_rows, m, ids, queries, out, B, d, squared,  \
                     stream);                                               \
  }

GATHER_DIST_ENTRY(gather_dist_f32, float)
GATHER_DIST_ENTRY(gather_dist_f16, __half)
GATHER_DIST_ENTRY(gather_dist_bf16, __nv_bfloat16)
