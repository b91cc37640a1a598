// gather_dist_q: out[b, j] = dist(q_b, codes[clip(ids[b, j], 0, N-1)] *
// scale), l2 or squared l2, for an int8 (sq8) store with a per-dimension
// float32 scale.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_dist_q/
// gather_dist_q.py::gather_dist_q_pallas (grid (B, d), one scalar-
// prefetched int8 row DMA per step, dequantized in VMEM).  Contract:
// kernels/gather_dist_q/ref.py.  The TPU wrapper's padding of m to 128
// lanes is not needed here: the kernel masks its own edge.
//
// Bound on the H100: bytes.  Each (b, j) reads m code bytes at a random
// address, and the scale and the query row (both shared and L2-resident)
// as floats; 4m flops.  Design: one warp per (b, j); the code row is read
// with 4-byte loads (4 codes, m = 192 is 48 of them), the scale and the
// query with the matching coalesced float4 loads; the codes are
// dequantized in registers (an unfused multiply, so each value equals the
// plain version's code * scale), the sum is kept in f32 and reduced with warp
// shuffles.  The float32 row never reaches device memory.
#include "common.cuh"

namespace {

__global__ void gather_dist_q_kernel(const signed char* __restrict__ codes,
                                     long long n_rows, int m,
                                     const float* __restrict__ scale,
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
  const signed char* row = codes + id * m;
  const float* q = queries + b * m;
  float s = 0.f;
  if (vec) {
    const char4* r4 = reinterpret_cast<const char4*>(row);
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = lane; i < (m >> 2); i += 32) {
      const char4 c = __ldg(r4 + i);
      const float4 sc = __ldg(s4 + i);
      const float4 qq = __ldg(q4 + i);
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
      const float dx =
          __fmul_rn(__ldg(row + i), __ldg(scale + i)) - __ldg(q + i);
      s = fmaf(dx, dx, s);
    }
  }
  s = repro::warp_sum(s);
  if (lane == 0) out[pair] = repro::finish_dist(s, squared != 0);
}

}  // namespace

REPRO_EXPORT int gather_dist_q_i8(const void* codes, long long n_rows, int m,
                                  const void* scale, const void* ids,
                                  const void* queries, void* out, int B, int d,
                                  int squared, void* stream) {
  const long long n_pairs = static_cast<long long>(B) * d;
  if (n_pairs == 0) return 0;
  // 4-byte code loads need m % 4 == 0 and a 4-byte aligned table; the
  // float4 loads of scale and queries need them 16-byte aligned
  const int vec = (m % 4 == 0) &&
                  reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(scale) |
                    reinterpret_cast<uintptr_t>(queries)) % 16 == 0);
  const int threads = 256;
  const long long blocks = (n_pairs * 32 + threads - 1) / threads;
  gather_dist_q_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(codes), n_rows, m,
      static_cast<const float*>(scale), static_cast<const int*>(ids),
      static_cast<const float*>(queries), static_cast<float*>(out), n_pairs, d,
      squared, vec);
  return static_cast<int>(cudaGetLastError());
}
