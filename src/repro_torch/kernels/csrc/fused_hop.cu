// fused_hop: one multi-expansion hop of the beam engine per query lane.
// For the E selected vertices of lane b: gather their adjacency rows, drop
// INVALID, >= n_valid, intra-hop repeats and visited ids, gather and score
// only the survivors, keep dist <= dmax[b], and compact the kept
// candidates stably in discovery order (e-major, j-minor).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_hop/
// fused_hop.py::fused_hop_pallas (grid (B, E), a sequential loop over the
// d neighbors with one gated row DMA each).  Contract:
// kernels/fused_hop/ref.py (= src/repro/kernels/fused_hop/ref.py).
//
// Bound on the H100: bytes.  The scored vector rows (m floats each) are
// most of the traffic; adjacency rows, probe slots and outputs are small.
// Design: one block per lane, the E selections in order and their d
// neighbors in parallel:
//   1. each thread takes positions p = e*d + j: adjacency entry, valid
//      mask, written to nbr_ids (valid-masked) and to shared memory;
//   2. first occurrence among earlier valid positions, and visited
//      membership at the id's P probe slots (the probe hash of
//      core/visited.py in native uint32; an id is only ever stored at one
//      of its own probes, so this equals the TPU kernel's whole-row
//      compare);
//   3. one warp per surviving position gathers its row with 16-byte loads
//      and reduces the distance: rows of filtered ids are never read;
//   4. a block-wide prefix sum over `keep` (warp ballots) gives each kept
//      candidate its compacted slot; the tail is padded INVALID / +inf.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) fused_hop_kernel(
    const int* __restrict__ adjacency, int deg,
    const float* __restrict__ vectors, long long n_rows, int m,
    const int* __restrict__ sel, const uint8_t* __restrict__ act, int E,
    const float* __restrict__ queries, const float* __restrict__ dmax,
    const int* __restrict__ visited, int V, int n_probes, int n_valid,
    int* __restrict__ cand_ids, float* __restrict__ cand_d,
    int* __restrict__ nbr_ids, int* __restrict__ evals, int squared,
    int vec4) {
  extern __shared__ int smem[];
  const int Ed = E * deg;
  int* nid_s = smem;                                        // Ed
  float* dist_s = reinterpret_cast<float*>(smem + Ed);      // Ed
  uint8_t* flag_s = reinterpret_cast<uint8_t*>(smem + 2 * Ed);  // Ed
  __shared__ int warp_keep[kWarps];
  __shared__ int warp_scored[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long out0 = b * Ed;

  // 1. adjacency rows of the selections; flag bit 0 = valid
  for (int p = tid; p < Ed; p += kThreads) {
    const int e = p / deg, j = p - e * deg;
    const bool a = act[b * E + e] != 0;
    int nid = a ? adjacency[static_cast<long long>(sel[b * E + e]) * deg + j]
                : repro::kInvalid;
    const bool valid = a && nid != repro::kInvalid && nid < n_valid;
    nid = valid ? nid : repro::kInvalid;
    nid_s[p] = nid;
    nbr_ids[out0 + p] = nid;
    flag_s[p] = valid ? 1 : 0;
  }
  __syncthreads();

  // 2. intra-hop first occurrence + visited filter; flag bit 1 = scored.
  // A valid id is never INVALID, so an invalid earlier slot never matches.
  for (int p = tid; p < Ed; p += kThreads) {
    if (!(flag_s[p] & 1)) continue;
    const int nid = nid_s[p];
    bool drop = false;
    for (int q = 0; q < p && !drop; ++q) drop = nid_s[q] == nid;
    if (V > 0) {
      const int* row = visited + b * V;
      const unsigned mask = static_cast<unsigned>(V - 1);
      for (int t = 0; t < n_probes && !drop; ++t)
        drop = row[repro::visited_probe(static_cast<unsigned>(nid), t,
                                        mask)] == nid;
    }
    if (!drop) flag_s[p] |= 2;
  }
  __syncthreads();

  // 3. gated row gather + distance, one warp per scored position
  const float* q = queries + b * m;
  for (int p = warp; p < Ed; p += kWarps) {
    if (!(flag_s[p] & 2)) continue;  // uniform across the warp
    long long id = nid_s[p];
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const float s = repro::warp_sq_l2(vectors + id * m, q, m, vec4 != 0, lane);
    if (lane == 0) dist_s[p] = repro::finish_dist(s, squared != 0);
  }
  __syncthreads();

  // 4. stable compaction: block-wide exclusive prefix sum of keep
  const float bound = dmax[b];
  int base = 0, n_scored = 0;
  for (int p0 = 0; p0 < Ed; p0 += kThreads) {
    const int p = p0 + tid;
    const bool scored = p < Ed && (flag_s[p] & 2);
    const bool keep = scored && dist_s[p] <= bound;
    const unsigned kb = __ballot_sync(repro::kFullMask, keep);
    const unsigned sb = __ballot_sync(repro::kFullMask, scored);
    if (lane == 0) {
      warp_keep[warp] = __popc(kb);
      warp_scored[warp] = __popc(sb);
    }
    __syncthreads();
    int before = 0, tile_keep = 0, tile_scored = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_keep[w] : 0;
      tile_keep += warp_keep[w];
      tile_scored += warp_scored[w];
    }
    if (keep) {
      const int slot = base + before + __popc(kb & ((1u << lane) - 1u));
      cand_ids[out0 + slot] = nid_s[p];
      cand_d[out0 + slot] = dist_s[p];
    }
    base += tile_keep;
    n_scored += tile_scored;
    __syncthreads();  // warp_keep is rewritten by the next tile
  }
  for (int p = base + tid; p < Ed; p += kThreads) {
    cand_ids[out0 + p] = repro::kInvalid;
    cand_d[out0 + p] = __int_as_float(0x7f800000);  // +inf
  }
  if (tid == 0) evals[b] = n_scored;
}

}  // namespace

// sel: (B, E) ids already clipped to [0, N); act: (B, E) uint8 flags;
// visited: (B, V) with V a power of two, or null with V = 0 (no filter).
REPRO_EXPORT int fused_hop_f32(const void* adjacency, int deg,
                               const void* vectors, long long n_rows, int m,
                               const void* sel, const void* act, int B, int E,
                               const void* queries, const void* dmax,
                               const void* visited, int V, int n_probes,
                               int n_valid, void* cand_ids, void* cand_d,
                               void* nbr_ids, void* evals, int squared,
                               void* stream) {
  if (B == 0) return 0;
  const int Ed = E * deg;
  const size_t smem = static_cast<size_t>(Ed) * (2 * sizeof(int) + 1);
  const int vec4 = (m % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(vectors) |
                     reinterpret_cast<uintptr_t>(queries)) % 16 == 0);
  fused_hop_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(adjacency), deg,
      static_cast<const float*>(vectors), n_rows, m,
      static_cast<const int*>(sel), static_cast<const uint8_t*>(act), E,
      static_cast<const float*>(queries), static_cast<const float*>(dmax),
      static_cast<const int*>(visited), V, n_probes, n_valid,
      static_cast<int*>(cand_ids), static_cast<float*>(cand_d),
      static_cast<int*>(nbr_ids), static_cast<int*>(evals), squared, vec4);
  return static_cast<int>(cudaGetLastError());
}
