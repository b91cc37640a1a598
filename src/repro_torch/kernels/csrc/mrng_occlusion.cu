// mrng_occlusion: for every (b, i, j) of (B, K, d) neighbor ids
//   nbr_dist[b, i, j] = dist(q_b, vectors[clip(nbr_ids[b, i, j], 0, N-1)])
//   occl[b, i, j]     = cand_d[b, i] > max(nbr_dist[b, i, j], w[b, i, j])
// (the lune test of Alg. 2), l2 or squared l2, for float32 rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mrng_occlusion/
// mrng_occlusion.py::mrng_occlusion_pallas (grid (B, K, d): one
// scalar-prefetched neighbor row DMA'd into VMEM per step).  Contract:
// kernels/mrng_occlusion/ref.py.
//
// Bound on the H100: bytes.  Each (b, i, j) reads one m-float row at a
// random address and does about 3m flops on it, far below the card's
// flop/byte ratio; the gathered (B, K, d, m) rows are the traffic.
// Design: one block per (b, i) with one warp per neighbor j.  The query
// row, read by every warp of the block, is staged once in shared memory;
// each neighbor row is read with coalesced 16-byte loads (m = 192 is 48
// float4), summed in f32 and reduced with warp shuffles
// (repro::warp_sq_l2), and lane 0 writes the distance and the flag
// (repro::lune_occludes).  The gathered rows never reach device memory.
// The extension's selection pass runs this test inside extend_select.cu;
// this kernel serves refinement's conformity test (mrng_conform_batch).
#include "common.cuh"

namespace {

__global__ void mrng_occlusion_kernel(const float* __restrict__ vectors,
                                      long long n_rows, int m,
                                      const int* __restrict__ nbr_ids,
                                      const float* __restrict__ queries,
                                      const float* __restrict__ cand_d,
                                      const float* __restrict__ weights,
                                      float* __restrict__ nbr_dist,
                                      unsigned char* __restrict__ occl,
                                      int K, int d, int squared, int vec4) {
  extern __shared__ __align__(16) float q_s[];
  const long long bi = blockIdx.x;  // b * K + i
  const long long b = bi / K;
  for (int t = threadIdx.x; t < m; t += blockDim.x) q_s[t] = queries[b * m + t];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float cd = cand_d[bi];
  for (int j = threadIdx.x >> 5; j < d; j += n_warps) {
    const long long pos = bi * d + j;
    long long id = nbr_ids[pos];
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    // the row loop and the lune test of repro:: (common.cuh), which
    // extend_select shares, so both give the same distances and flags
    const float s =
        repro::warp_sq_l2<true>(vectors + id * m, q_s, m, vec4 != 0, lane);
    if (lane == 0) {
      const float dist = repro::finish_dist(s, squared != 0);
      nbr_dist[pos] = dist;
      occl[pos] = repro::lune_occludes(cd, dist, weights[pos]) ? 1 : 0;
    }
  }
}

}  // namespace

REPRO_EXPORT int mrng_occlusion_f32(const void* vectors, long long n_rows,
                                    int m, const void* nbr_ids,
                                    const void* queries, const void* cand_d,
                                    const void* weights, void* nbr_dist,
                                    void* occl, int B, int K, int d,
                                    int squared, void* stream) {
  const long long blocks = static_cast<long long>(B) * K;
  if (blocks == 0 || d == 0) return 0;
  const int vec4 = (m % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(vectors) % 16 == 0);
  const int threads = 32 * (d < 32 ? d : 32);
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  mrng_occlusion_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), n_rows, m,
      static_cast<const int*>(nbr_ids), static_cast<const float*>(queries),
      static_cast<const float*>(cand_d), static_cast<const float*>(weights),
      static_cast<float*>(nbr_dist), static_cast<unsigned char*>(occl), K, d,
      squared, vec4);
  return static_cast<int>(cudaGetLastError());
}
