// pq_adc: out[b, j] = sum_s lut_b[s, codes[clip(ids[b, j], 0, N-1), s]],
// or its square root, where lut_b[s, c] = ||q_b[s] - C[s, c]||^2 is query
// b's table of squared sub-distances (asymmetric distance computation for
// a product-quantized store).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_adc/pq_adc.py::
// pq_adc_pallas (grid (B, d); step (i, 0) builds query i's LUT in VMEM
// with a 0/1 selector matmul on the MXU, every step one-hot-selects the
// m_sub entries of one scalar-prefetched code row).  Contract:
// kernels/pq_adc/ref.py on natural operands: the selector, the 128-lane
// padding and the flattened codebook exist for the TPU's matrix unit and
// are not carried over.
//
// Bound on the H100: bytes at serving's shapes.  The function's cheaper
// form scores the d gathered rows of a query straight from the codebooks,
// 3 * d * dim flops (11,520 at d = 20, dim = 192); building the query's
// whole table costs 3 * 256 * dim (147,456), so at d = 20 this kernel does
// 12.8x the work the bound counts (the table pays off only from d = 256).
// Design: one block per query row b.  The block stages the query in
// shared memory and builds b's (m_sub, 256) table there, one entry per
// thread (the codebook is read once per block, L2-resident across the
// blocks); each row of the table is padded to 257 floats, so lane t,
// reading subspace t's entry for code c_t, hits bank (t + c_t) mod 32: the
// 32 lanes fall on distinct banks when they share a code, but random codes
// collide as often as without the padding.  Then one warp per gathered
// code row: lane t takes subspaces t, t+32, ..., reads one code byte and
// one table entry each, and the warp reduces with shuffles.  The table's
// build and the row sum are common.cuh's pq_build_lut and pq_row_sum,
// which beam_search runs too.  At most 128 subspaces: 131,584 bytes of
// table plus the query, above 48 KB through the dynamic shared memory
// attribute.  The table is rebuilt on every call (every hop of the host
// loop), as the TPU kernel rebuilds it; beam_search builds it once a
// search.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pq_adc_kernel(const unsigned char* __restrict__ codes,
                              long long n_rows, int m_sub,
                              const float* __restrict__ codebooks, int dsub,
                              const int* __restrict__ ids,
                              const float* __restrict__ queries,
                              float* __restrict__ out, int d, int squared) {
  extern __shared__ float smem[];
  float* lut = smem;                                 // (m_sub, kPqStride)
  float* q = smem + m_sub * repro::kPqStride;        // (dim,)
  const long long b = blockIdx.x;
  const int dim = m_sub * dsub;
  for (int i = threadIdx.x; i < dim; i += blockDim.x)
    q[i] = __ldg(queries + b * dim + i);
  __syncthreads();
  repro::pq_build_lut(lut, q, codebooks, m_sub, dsub);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int j = warp; j < d; j += n_warps) {
    long long id = ids[b * d + j];
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const float s = repro::pq_row_sum(lut, codes + id * m_sub, m_sub, lane);
    if (lane == 0) out[b * d + j] = repro::finish_dist(s, squared != 0);
  }
}

}  // namespace

REPRO_EXPORT int pq_adc_u8(const void* codes, long long n_rows, int m_sub,
                           const void* codebooks, int dsub, const void* ids,
                           const void* queries, void* out, int B, int d,
                           int squared, void* stream) {
  if (B == 0 || d == 0) return 0;
  const size_t smem = (static_cast<size_t>(m_sub) * repro::kPqStride +
                       m_sub * dsub) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pq_adc_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(codes), n_rows, m_sub,
      static_cast<const float*>(codebooks), dsub, static_cast<const int*>(ids),
      static_cast<const float*>(queries), static_cast<float*>(out), d,
      squared);
  return static_cast<int>(cudaGetLastError());
}
