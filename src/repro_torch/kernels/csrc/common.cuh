// Shared by every kernel library of the port (see kernels/_build.py): the
// row distances of gather_dist, gather_dist_q, fused_hop, mrng_occlusion,
// beam_search and extend_select, the pq table and its row sum of pq_adc
// and beam_search, the lune test of mrng_occlusion and extend_select, the
// merge order of beam_merge and beam_search, and the visited set's probe
// hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kInvalid = -1;   // core/graph.py INVALID
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  return s;
}

// A load of the query side of a distance: through the read-only cache from
// device memory, or plainly from shared memory (kShared), where __ldg
// does not reach.  Both give the same value, so the sums below do not
// depend on where the query lies.
template <bool kShared, typename V>
__device__ __forceinline__ V load_q(const V* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Squared l2 distance between two rows of m floats, computed by one warp;
// every lane returns the full sum.  vec4 selects 16-byte loads (m % 4 == 0
// and both rows 16-byte aligned).  b lies in shared memory if kSharedB.
template <bool kSharedB = false>
__device__ __forceinline__ float warp_sq_l2(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int m, bool vec4, int lane) {
  float s = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = lane; i < (m >> 2); i += 32) {
      float4 x = __ldg(a4 + i);
      float4 y = load_q<kSharedB>(b4 + i);
      float dx = x.x - y.x, dy = x.y - y.y, dz = x.z - y.z, dw = x.w - y.w;
      s = fmaf(dx, dx, s);
      s = fmaf(dy, dy, s);
      s = fmaf(dz, dz, s);
      s = fmaf(dw, dw, s);
    }
  } else {
    for (int i = lane; i < m; i += 32) {
      float dx = __ldg(a + i) - load_q<kSharedB>(b + i);
      s = fmaf(dx, dx, s);
    }
  }
  return warp_sum(s);
}

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
// (m % 8 == 0 and both rows 16-byte aligned).  q lies in shared memory if
// kSharedQ.
template <typename T, bool kSharedQ = false>
__device__ __forceinline__ float warp_sq_l2_half(const T* __restrict__ row,
                                                 const float* __restrict__ q,
                                                 int m, bool vec, int lane) {
  float s = 0.f;
  if (vec) {
    const uint4* r8 = reinterpret_cast<const uint4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = lane; i < (m >> 3); i += 32) {
      const uint4 raw = __ldg(r8 + i);
      const float4 qa = load_q<kSharedQ>(q4 + 2 * i);
      const float4 qb = load_q<kSharedQ>(q4 + 2 * i + 1);
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
      const float dx = to_f32(row[i]) - load_q<kSharedQ>(q + i);
      s = fmaf(dx, dx, s);
    }
  }
  return warp_sum(s);
}

// The squared distance of a float32, fp16 or bf16 row to a float32 query,
// as gather_dist computes it: one device function for every kernel that
// scores rows, so that their distances agree bit for bit.
template <bool kSharedQ, typename T>
__device__ __forceinline__ float row_sq_l2(const T* row, const float* q,
                                           int m, bool vec, int lane) {
  if constexpr (std::is_same_v<T, float>) {
    return warp_sq_l2<kSharedQ>(row, q, m, vec, lane);
  } else {
    return warp_sq_l2_half<T, kSharedQ>(row, q, m, vec, lane);
  }
}

// Elements of T per 16-byte load: the vec condition is m % per_load == 0.
template <typename T>
constexpr int per_load() { return 16 / static_cast<int>(sizeof(T)); }

// The squared distance of an sq8 code row of m int8 codes, dequantized by
// the (m,) float32 scale, to a float32 query, as gather_dist_q computes it:
// one warp, every lane returns the full sum.  Each value is code * scale
// by an unfused multiply (__fmul_rn: never contracted into an FMA), so it
// equals the plain version's dequantized value.  vec selects 4-byte code
// loads with the matching float4 loads of scale and query (q8_vec).  The
// scale and the query lie in shared memory if kSharedQ.
template <bool kSharedQ = false>
__device__ __forceinline__ float row_sq_l2_q8(
    const signed char* __restrict__ row, const float* __restrict__ scale,
    const float* __restrict__ q, int m, bool vec, int lane) {
  float s = 0.f;
  if (vec) {
    const char4* r4 = reinterpret_cast<const char4*>(row);
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = lane; i < (m >> 2); i += 32) {
      const char4 c = __ldg(r4 + i);
      const float4 sc = load_q<kSharedQ>(s4 + i);
      const float4 qq = load_q<kSharedQ>(q4 + i);
      const float dx = __fmul_rn(c.x, sc.x) - qq.x;
      const float dy = __fmul_rn(c.y, sc.y) - qq.y;
      const float dz = __fmul_rn(c.z, sc.z) - qq.z;
      const float dw = __fmul_rn(c.w, sc.w) - qq.w;
      s = fmaf(dx, dx, s);
      s = fmaf(dy, dy, s);
      s = fmaf(dz, dz, s);
      s = fmaf(dw, dw, s);
    }
  } else {
    for (int i = lane; i < m; i += 32) {
      const float dx = __fmul_rn(__ldg(row + i), load_q<kSharedQ>(scale + i)) -
                       load_q<kSharedQ>(q + i);
      s = fmaf(dx, dx, s);
    }
  }
  return warp_sum(s);
}

// gather_dist_q's vec choice, from the device pointers of the code table,
// the scale and the queries: 4-byte code loads need m % 4 == 0 and a
// 4-byte aligned table, the float4 loads of scale and queries 16-byte
// alignment.  Every kernel that scores sq8 rows takes it from the same
// pointers, so that the sums run in the same order.
__host__ __device__ inline bool q8_vec(const void* codes, const void* scale,
                                       const void* queries, int m) {
  return (m % 4 == 0) && reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(scale) |
           reinterpret_cast<uintptr_t>(queries)) % 16 == 0);
}

__device__ __forceinline__ float finish_dist(float s, bool squared) {
  s = fmaxf(s, 0.f);
  return squared ? s : sqrtf(s);
}

// The lune test of Alg. 2 as mrng_occlusion_ref computes it: does the
// neighbor at distance dist from the new point, joined to the candidate by
// an edge of weight w, occlude the candidate edge of length cand_d?
// cand_d > max(dist, w), where torch.maximum propagates NaN (fmaxf would
// drop it), so a NaN on either side occludes nothing.
__device__ __forceinline__ bool lune_occludes(float cand_d, float dist,
                                              float w) {
  const float mx = (isnan(dist) || isnan(w)) ? __int_as_float(0x7fc00000)
                                             : fmaxf(dist, w);
  return cand_d > mx;
}

// The pq store's asymmetric distance, shared by pq_adc and beam_search so
// that their distances agree bit for bit.  A query's table holds
// ||q_s - C[s, c]||^2 for each subspace s and centroid c, in rows of
// kPqStride floats: lane t, reading subspace t's entry for code c_t, hits
// bank (t + c_t) mod 32, so the 32 lanes fall on distinct banks when they
// share a code.
constexpr int kPqCentroids = 256;
constexpr int kPqStride = kPqCentroids + 1;

// Fill lut (m_sub rows of kPqStride floats, shared memory) from the query
// q (m_sub * dsub floats, shared memory) and the (m_sub, 256, dsub)
// codebooks: one entry a thread of the block, a sequential fmaf chain over
// the dsub dims.  The caller synchronises the block after it.
__device__ __forceinline__ void pq_build_lut(float* lut, const float* q,
                                             const float* __restrict__ books,
                                             int m_sub, int dsub) {
  // codebooks[s, c, :] starts at (s * 256 + c) * dsub = e * dsub
  for (int e = threadIdx.x; e < m_sub * kPqCentroids; e += blockDim.x) {
    const int s = e / kPqCentroids, c = e % kPqCentroids;
    const float* cent = books + static_cast<long long>(e) * dsub;
    const float* qs = q + s * dsub;
    float acc = 0.f;
    for (int k = 0; k < dsub; ++k) {
      const float t = qs[k] - __ldg(cent + k);
      acc = fmaf(t, t, acc);
    }
    lut[s * kPqStride + c] = acc;
  }
}

// The table sum of one code row of m_sub bytes, one warp: lane t takes
// subspaces t, t+32, ..., then the shuffle reduction; every lane returns
// the full sum.
__device__ __forceinline__ float pq_row_sum(const float* lut,
                                            const uint8_t* __restrict__ row,
                                            int m_sub, int lane) {
  float s = 0.f;
  for (int t = lane; t < m_sub; t += 32)
    s += lut[t * kPqStride + __ldg(row + t)];
  return warp_sum(s);
}

// An asynchronous copy of kBytes (4, 8 or 16) from device to shared memory
// (cp.async, cached at every level), its group commit, and the wait until
// at most N of this thread's groups are in flight.  After the wait, a
// __syncwarp or __syncthreads makes the copies visible to the other lanes.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async size");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The total order of a stable ascending sort of keys a at rank ra: by key,
// then by rank, with NaN after every number.
__device__ __forceinline__ bool precedes(float a, int ra, float b, int rb) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? ra < rb : nb;
  return a < b || (a == b && ra < rb);
}

// Slot of id x at probe t in a visited table of mask + 1 slots: the double
// hash of core/visited.py::probe_positions in native uint32.
__device__ __forceinline__ unsigned visited_probe(unsigned x, unsigned t,
                                                  unsigned mask) {
  const unsigned h1 = x * 2654435761u;           // visited.py _MULT1
  const unsigned h2 = (x * 0x9E3779B1u) | 1u;    // visited.py _MULT2, odd
  return (h1 + t * h2) & mask;
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
