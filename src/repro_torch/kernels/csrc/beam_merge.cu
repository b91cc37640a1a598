// beam_merge: fold d scored candidates into the sorted width-L beam of
// every lane.  Output = the first L entries of a stable argsort of the
// concatenation [beam | candidates], payload (id, checked, excluded)
// carried through.
//
// Replaces the Pallas TPU kernel src/repro/kernels/beam_merge/
// beam_merge.py::beam_merge_pallas (bitonic sort of the candidates, then
// one bitonic merge, keyed on (dist, rank)).  Contract:
// kernels/beam_merge/ref.py.
//
// Bound on the H100: bytes (about 10 bytes in per entry, 10 out per kept
// entry, a few compares each); at the main path's B = 256, L = 30 lanes
// the launch itself dominates.
// Design: one block per lane.  The L + d keys go to shared memory; each
// thread takes one entry and counts the entries that precede it in the
// total order (dist, rank), with rank = position in the concatenation and
// NaN after every number, as a stable sort places it.  That count is the
// entry's output position, so entries at positions < L are written
// straight to their slot.  The keys are unique, so this is exactly the
// stable argsort, ties at +inf included; the TPU kernel's bitonic network
// needs power-of-two padding and lane-wide exchanges that buy nothing for
// L + d of a few hundred, where (L + d)^2 shared-memory compares per lane
// are cheaper than the network's barriers.
#include "common.cuh"

namespace {

__global__ void beam_merge_kernel(
    const float* __restrict__ beam_d, const int* __restrict__ beam_i,
    const uint8_t* __restrict__ beam_c, const uint8_t* __restrict__ beam_x,
    const float* __restrict__ cand_d, const int* __restrict__ cand_i,
    const uint8_t* __restrict__ cand_c, const uint8_t* __restrict__ cand_x,
    float* __restrict__ out_d, int* __restrict__ out_i,
    uint8_t* __restrict__ out_c, uint8_t* __restrict__ out_x, int L, int d) {
  extern __shared__ float keys[];  // L + d
  const int T = L + d;
  const long long b = blockIdx.x;
  const long long bo = b * L, co = b * d;
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    keys[i] = i < L ? beam_d[bo + i] : cand_d[co + i - L];
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const float key = keys[i];
    int pos = 0;
    for (int j = 0; j < T; ++j) pos += repro::precedes(keys[j], j, key, i);
    if (pos >= L) continue;
    const long long o = bo + pos;
    out_d[o] = key;
    if (i < L) {
      out_i[o] = beam_i[bo + i];
      out_c[o] = beam_c[bo + i];
      out_x[o] = beam_x[bo + i];
    } else {
      const long long c = co + i - L;
      out_i[o] = cand_i[c];
      out_c[o] = cand_c ? cand_c[c] : 0;
      out_x[o] = cand_x[c];
    }
  }
}

}  // namespace

// cand_chk may be null: fresh candidates are unchecked.
REPRO_EXPORT int beam_merge_f32(const void* beam_d, const void* beam_i,
                                const void* beam_c, const void* beam_x,
                                const void* cand_d, const void* cand_i,
                                const void* cand_c, const void* cand_x,
                                void* out_d, void* out_i, void* out_c,
                                void* out_x, int B, int L, int d,
                                void* stream) {
  if (B == 0 || L == 0) return 0;
  const int T = L + d;
  int threads = ((T + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  beam_merge_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(beam_d), static_cast<const int*>(beam_i),
      static_cast<const uint8_t*>(beam_c), static_cast<const uint8_t*>(beam_x),
      static_cast<const float*>(cand_d), static_cast<const int*>(cand_i),
      static_cast<const uint8_t*>(cand_c), static_cast<const uint8_t*>(cand_x),
      static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<uint8_t*>(out_c), static_cast<uint8_t*>(out_x), L, d);
  return static_cast<int>(cudaGetLastError());
}
