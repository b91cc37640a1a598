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
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float2 to_f32x2(unsigned w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

__device__ __forceinline__ float2 to_f32x2(unsigned w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Squared l2 distance between a row of m halves and m query floats, one
// warp; every lane returns the full sum.  vec selects 16-byte loads
// (m % 8 == 0 and both rows 16-byte aligned).
template <typename T>
__device__ __forceinline__ float warp_sq_l2_half(const T* __restrict__ row,
                                                 const float* __restrict__ q,
                                                 int m, bool vec, int lane) {
  float s = 0.f;
  if (vec) {
    const uint4* r8 = reinterpret_cast<const uint4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = lane; i < (m >> 3); i += 32) {
      const uint4 raw = __ldg(r8 + i);
      const float4 qa = __ldg(q4 + 2 * i);
      const float4 qb = __ldg(q4 + 2 * i + 1);
      const float2 x0 = to_f32x2(raw.x, T()), x1 = to_f32x2(raw.y, T());
      const float2 x2 = to_f32x2(raw.z, T()), x3 = to_f32x2(raw.w, T());
      const float dx[8] = {x0.x - qa.x, x0.y - qa.y, x1.x - qa.z,
                           x1.y - qa.w, x2.x - qb.x, x2.y - qb.y,
                           x3.x - qb.z, x3.y - qb.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) s = fmaf(dx[k], dx[k], s);
    }
  } else {
    for (int i = lane; i < m; i += 32) {
      const float dx = to_f32(row[i]) - __ldg(q + i);
      s = fmaf(dx, dx, s);
    }
  }
  return repro::warp_sum(s);
}

__device__ __forceinline__ float row_sq_l2(const float* row, const float* q,
                                           int m, bool vec, int lane) {
  return repro::warp_sq_l2(row, q, m, vec, lane);
}

template <typename T>
__device__ __forceinline__ float row_sq_l2(const T* row, const float* q,
                                           int m, bool vec, int lane) {
  return warp_sq_l2_half(row, q, m, vec, lane);
}

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
  const float s = row_sq_l2(vectors + id * m, queries + b * m, m, vec != 0,
                            lane);
  if (lane == 0) out[pair] = repro::finish_dist(s, squared != 0);
}

// Elements of T per 16-byte load.
template <typename T>
constexpr int per_load() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T>
int launch(const void* vectors, long long n_rows, int m, const void* ids,
           const void* queries, void* out, int B, int d, int squared,
           void* stream) {
  const long long n_pairs = static_cast<long long>(B) * d;
  if (n_pairs == 0) return 0;
  const int vec = (m % per_load<T>() == 0) &&
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
