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
// as floats; 4m flops.  Design: one warp per (b, j); the row function,
// repro::row_sq_l2_q8 in common.cuh (which beam_search shares), reads the
// code row with 4-byte loads (4 codes, m = 192 is 48 of them), the scale
// and the query with the matching coalesced float4 loads, dequantizes in
// registers (an unfused multiply, so each value equals the plain
// version's code * scale), keeps the sum in f32 and reduces it with warp
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
  const float s = repro::row_sq_l2_q8(codes + id * m, scale, queries + b * m,
                                     m, vec != 0, lane);
  if (lane == 0) out[pair] = repro::finish_dist(s, squared != 0);
}

}  // namespace

REPRO_EXPORT int gather_dist_q_i8(const void* codes, long long n_rows, int m,
                                  const void* scale, const void* ids,
                                  const void* queries, void* out, int B, int d,
                                  int squared, void* stream) {
  const long long n_pairs = static_cast<long long>(B) * d;
  if (n_pairs == 0) return 0;
  const int vec = repro::q8_vec(codes, scale, queries, m);
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
