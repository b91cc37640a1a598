// extend_select: the selection pass of the Alg. 3 extension
// (core/extend.py::extend_wave_device) for W new vertices in one launch.
// For lane w with candidates cand (K, ascending by distance, INVALID-padded)
// and the point q_w that takes id v_w:
//   1. the neighbor gather: candidate i is valid if cand[i] is not INVALID
//      and cand[i] < v_w; its d neighbors nbr[i, j] and their edge weights
//      w[i, j] are the adjacency and weight rows of cand[i] (INVALID and 0
//      for an invalid candidate);
//   2. the lune test of Alg. 2 (mrng_occlusion): nd[i, j] = dist(q_w,
//      vectors[nbr[i, j]]) (inf for an INVALID neighbor) and occl[i, j] =
//      cand_d[i] > max(nd[i, j], w[i, j]);
//   3. d/2 masked selection steps: the first eligible candidate b (not yet
//      in U, with a neighbor not in U, and, until the phase-2 latch, no
//      neighbor in U occluding it), then its neighbor n by the scheme (C:
//      the first largest weight, B: the first smallest, A: the first
//      smallest nd, D: the first smallest nd - w, over the neighbors not in
//      U); U takes (b, n) at slots 2t, 2t+1 with their distances; a lane
//      with no eligible candidate fails (ok = false) and stops.
// Outputs sel_ids (W, d) int32, sel_dists (W, d) float32, ok (W,) bool.
//
// Replaces, on this path, the Pallas TPU kernel
// src/repro/kernels/mrng_occlusion/mrng_occlusion.py::mrng_occlusion_pallas
// (:50) together with the fori_loop of d/2 selection steps around it,
// src/repro/core/extend.py:58-140.  Contract: kernels/extend_select/ref.py.
//
// Bound on the H100: bytes.  A lane reads K adjacency and weight rows and
// up to K * d vector rows of m floats at random addresses (about 614 KB at
// K = 40, d = 20, m = 192); the selection steps are a few hundred
// instructions of one warp on data in shared memory.
//
// Design: one thread-block cluster of up to 8 CTAs a lane (launched with
// cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension), so that a
// block of 16 lanes reads its rows through 128 SMs, not 16.
//   - Scoring: CTA r of the cluster takes candidates i = r, r + 8, ...;
//     one warp a (i, j) pair reads the adjacency and weight entry and
//     scores the neighbor row against the query staged in its shared
//     memory with repro::warp_sq_l2 and repro::lune_occludes, the device
//     functions of mrng_occlusion, so nd and occl are bit-identical to the
//     two-step path's (mrng_occlusion kernel, then the torch steps).
//   - Collecting: each warp writes nbr, nd, w and occl of its pair into
//     the rank-0 CTA's shared memory through distributed shared memory
//     (cluster.map_shared_rank), 13 bytes a pair; cluster.sync() publishes
//     them (a first cluster.sync() makes sure rank 0 runs before any
//     write reaches it).
//   - Selecting: one warp of rank 0 runs the d/2 steps on per-candidate
//     bit masks of the d <= 64 neighbors (valid, occluding, in U), kept in
//     shared memory.  U only grows, so "in U" is updated from the two ids
//     each step adds.  Every "first" is an explicit minimum over
//     positions (ballots, then __ffs), and a maximum or minimum over a row
//     follows torch.amax / amin: a NaN key makes no position equal it, so
//     position 0 is taken, as extend.py::_first_max / _first_min take it.
#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDegree = 64;        // the neighbor masks are 64-bit
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may use
enum Scheme { kA = 0, kB = 1, kC = 2, kD = 3 };

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

// Byte offsets of the shared-memory sections, each 16-byte aligned; every
// CTA of a cluster has the same layout, and only rank 0's sections past q
// are used.  kernels/extend_select/ops.py::smem_bytes repeats this sum.
struct Layout {
  size_t q, cid, cdist, nid, nd, nw, occ, nv, oc, inu, cval, cinu, uid, ud,
      total;
};

__host__ __device__ inline Layout make_layout(int m, int K, int D) {
  Layout o;
  size_t at = 0;
  const size_t KD = static_cast<size_t>(K) * D;
  o.q = take(at, 4 * static_cast<size_t>(m));
  o.cid = take(at, 4 * static_cast<size_t>(K));
  o.cdist = take(at, 4 * static_cast<size_t>(K));
  o.nid = take(at, 4 * KD);
  o.nd = take(at, 4 * KD);
  o.nw = take(at, 4 * KD);
  o.occ = take(at, KD);
  o.nv = take(at, 8 * static_cast<size_t>(K));
  o.oc = take(at, 8 * static_cast<size_t>(K));
  o.inu = take(at, 8 * static_cast<size_t>(K));
  o.cval = take(at, K);
  o.cinu = take(at, K);
  o.uid = take(at, 4 * static_cast<size_t>(D));
  o.ud = take(at, 4 * static_cast<size_t>(D));
  o.total = at;
  return o;
}

struct Params {
  const int* adjacency;
  const float* weights;
  long long adj_rows;
  int D;
  const float* vectors;
  long long n_rows;
  int m;
  const int* cand_ids;
  const float* cand_dists;
  const float* queries;
  const int* v_ids;
  int* sel_ids;
  float* sel_dists;
  uint8_t* ok;
  int K, scheme, rng_checks, squared, vec4;
};

// The key of neighbor j of the selected candidate under the scheme, with
// the masked value of extend.py for a neighbor that is not available.
__device__ __forceinline__ float scheme_key(int scheme, bool avail, float w,
                                            float nd) {
  const float inf = CUDART_INF_F;
  switch (scheme) {
    case kC:
      return avail ? w : -inf;
    case kB:
      return avail ? w : inf;
    case kA:
      return avail ? nd : inf;
    default:
      return avail ? nd - w : inf;
  }
}

__global__ void __launch_bounds__(kThreads)
    extend_select_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, D = p.D, m = p.m;
  const Layout lay = make_layout(m, K, D);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  int* cid = reinterpret_cast<int*>(smem + lay.cid);
  float* cdist = reinterpret_cast<float*>(smem + lay.cdist);
  int* nid = reinterpret_cast<int*>(smem + lay.nid);
  float* nd = reinterpret_cast<float*>(smem + lay.nd);
  float* nw = reinterpret_cast<float*>(smem + lay.nw);
  uint8_t* occ = smem + lay.occ;
  unsigned long long* nv =
      reinterpret_cast<unsigned long long*>(smem + lay.nv);
  unsigned long long* oc =
      reinterpret_cast<unsigned long long*>(smem + lay.oc);
  unsigned long long* inu =
      reinterpret_cast<unsigned long long*>(smem + lay.inu);
  uint8_t* cval = smem + lay.cval;
  uint8_t* cinu = smem + lay.cinu;
  int* uid = reinterpret_cast<int*>(smem + lay.uid);
  float* ud = reinterpret_cast<float*>(smem + lay.ud);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const long long w = blockIdx.x / cs;   // the lane
  const int v_id = p.v_ids[w];
  const float inf = CUDART_INF_F;

  for (int i = tid; i < m; i += kThreads) q_s[i] = p.queries[w * m + i];
  if (rank == 0) {
    for (int i = tid; i < K; i += kThreads) {
      cid[i] = p.cand_ids[w * K + i];
      cdist[i] = p.cand_dists[w * K + i];
    }
    for (int j = tid; j < D; j += kThreads) {
      uid[j] = repro::kInvalid;
      ud[j] = inf;
    }
  }
  // every CTA of the cluster runs, and each has staged its query
  cluster.sync();

  // 1-2. gather and lune test of this CTA's candidates, one warp a pair,
  // written into rank 0's sections
  int* nid0 = cluster.map_shared_rank(nid, 0);
  float* nd0 = cluster.map_shared_rank(nd, 0);
  float* nw0 = cluster.map_shared_rank(nw, 0);
  uint8_t* occ0 = cluster.map_shared_rank(occ, 0);
  const int n_local = rank < K ? (K - rank + cs - 1) / cs : 0;
  for (int task = warp; task < n_local * D; task += kWarps) {
    const int i = rank + (task / D) * cs, j = task % D;
    const int cand = p.cand_ids[w * K + i];
    const bool valid = cand != repro::kInvalid && cand < v_id;
    int nbr = repro::kInvalid;
    float wt = 0.f, dist = inf;
    bool occl = false;
    if (valid) {   // uniform across the warp
      long long row = cand;
      row = row < 0 ? 0 : (row >= p.adj_rows ? p.adj_rows - 1 : row);
      nbr = p.adjacency[row * D + j];
      wt = p.weights[row * D + j];
    }
    if (nbr != repro::kInvalid) {
      long long id = nbr;
      id = id < 0 ? 0 : (id >= p.n_rows ? p.n_rows - 1 : id);
      const float s = repro::warp_sq_l2<true>(p.vectors + id * m, q_s, m,
                                              p.vec4 != 0, lane);
      dist = repro::finish_dist(s, p.squared != 0);
      occl = repro::lune_occludes(p.cand_dists[w * K + i], dist, wt);
    }
    if (lane == 0) {
      const int at = i * D + j;
      nid0[at] = nbr;
      nd0[at] = dist;
      nw0[at] = wt;
      occ0[at] = occl ? 1 : 0;
    }
  }
  // every pair has reached rank 0 (release / acquire across the cluster)
  cluster.sync();
  if (rank != 0 || warp != 0) return;

  // 3. the selection steps, one warp.  Lane l keeps candidates l, l + 32,
  // ...: their masks of valid and occluding neighbors
  for (int i = lane; i < K; i += 32) {
    unsigned long long valid_m = 0, occl_m = 0;
    for (int j = 0; j < D; ++j) {
      const unsigned long long bit = 1ull << j;
      if (nid[i * D + j] != repro::kInvalid) {
        valid_m |= bit;
        if (occ[i * D + j]) occl_m |= bit;
      }
    }
    nv[i] = valid_m;
    oc[i] = occl_m;
    inu[i] = 0;
    cval[i] = cid[i] != repro::kInvalid && cid[i] < v_id;
    cinu[i] = 0;
  }
  __syncwarp();
  bool skip = !p.rng_checks, fail = false;
  for (int t = 0; t < D / 2; ++t) {
    // the first eligible candidate, with and without the Alg. 2 check
    int first_base = K, first_mrng = K;
    for (int base = 0; base < K; base += 32) {
      const int i = base + lane;
      bool eb = false, em = false;
      if (i < K) {
        const unsigned long long in_u = inu[i];
        eb = cval[i] && !cinu[i] && (nv[i] & ~in_u) != 0;
        em = eb && (oc[i] & in_u) == 0;
      }
      const unsigned bb = __ballot_sync(repro::kFullMask, eb);
      const unsigned bm = __ballot_sync(repro::kFullMask, em);
      if (first_base == K && bb) first_base = base + __ffs(bb) - 1;
      if (first_mrng == K && bm) first_mrng = base + __ffs(bm) - 1;
    }
    skip = skip || first_mrng == K;   // the phase-2 latch
    const int isel = skip ? first_base : first_mrng;
    if (isel == K) {   // no eligible candidate: U stays as it is
      fail = true;
      break;
    }
    // its neighbor by the scheme: the first position of the row's
    // maximum (C) or minimum, none if the row holds a NaN key
    const unsigned long long avail = nv[isel] & ~inu[isel];
    const int ja = lane, jb = lane + 32;
    const bool ina = ja < D, inb = jb < D;
    const float ka = ina ? scheme_key(p.scheme, (avail >> ja) & 1,
                                      nw[isel * D + ja], nd[isel * D + ja])
                         : 0.f;
    const float kb = inb ? scheme_key(p.scheme, (avail >> jb) & 1,
                                      nw[isel * D + jb], nd[isel * D + jb])
                         : 0.f;
    const bool has_nan = __any_sync(repro::kFullMask,
                                    (ina && isnan(ka)) || (inb && isnan(kb)));
    int jsel = 0;
    if (!has_nan) {
      const bool largest = p.scheme == kC;
      const float none = largest ? -inf : inf;
      float e = ina ? ka : none;
      if (inb) e = largest ? fmaxf(e, kb) : fminf(e, kb);
      for (int o = 16; o > 0; o >>= 1) {
        const float x = __shfl_xor_sync(repro::kFullMask, e, o);
        e = largest ? fmaxf(e, x) : fminf(e, x);
      }
      const unsigned ha = __ballot_sync(repro::kFullMask, ina && ka == e);
      const unsigned hb = __ballot_sync(repro::kFullMask, inb && kb == e);
      jsel = ha ? __ffs(ha) - 1 : (hb ? 32 + __ffs(hb) - 1 : 0);
    }
    const int b = cid[isel], n = nid[isel * D + jsel];
    if (lane == 0) {
      uid[2 * t] = b;
      uid[2 * t + 1] = n;
      ud[2 * t] = cdist[isel];
      ud[2 * t + 1] = nd[isel * D + jsel];
    }
    // b and n join U (both are valid ids, so an INVALID slot never
    // matches)
    for (int i = lane; i < K; i += 32) {
      if (cval[i] && (cid[i] == b || cid[i] == n)) cinu[i] = 1;
      unsigned long long add = 0;
      for (int j = 0; j < D; ++j) {
        const int v = nid[i * D + j];
        if (v == b || v == n) add |= 1ull << j;
      }
      inu[i] |= add;
    }
    __syncwarp();
  }
  for (int j = lane; j < D; j += 32) {
    p.sel_ids[w * D + j] = uid[j];
    p.sel_dists[w * D + j] = ud[j];
  }
  if (lane == 0) p.ok[w] = fail ? 0 : 1;
}

}  // namespace

// adjacency, weights (adj_rows, D) int32 / float32; vectors (n_rows, m)
// float32; cand_ids, cand_dists (W, K) int32 / float32; queries (W, m)
// float32; v_ids (W,) int32; out: sel_ids (W, D) int32, sel_dists (W, D)
// float32, ok (W,) uint8 (torch.bool).  scheme 0-3 is A-D; cluster: CTAs a
// lane, 1 to 8.  smem_bytes must equal the kernel's own layout.
REPRO_EXPORT int extend_select_f32(
    const void* adjacency, const void* weights, long long adj_rows, int D,
    const void* vectors, long long n_rows, int m, const void* cand_ids,
    const void* cand_dists, const void* queries, const void* v_ids,
    void* sel_ids, void* sel_dists, void* ok, int W, int K, int scheme,
    int rng_checks, int squared, int cluster, long long smem_bytes,
    void* stream) {
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (smem != make_layout(m, K, D).total || smem > kMaxSmem || D < 1 ||
      D > kMaxDegree || K < 1 || cluster < 1 || cluster > kMaxCluster ||
      scheme < kA || scheme > kD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) return 0;
  static size_t opted_in = 48 * 1024;   // the default limit
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        extend_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  Params p;
  p.adjacency = static_cast<const int*>(adjacency);
  p.weights = static_cast<const float*>(weights);
  p.adj_rows = adj_rows;
  p.D = D;
  p.vectors = static_cast<const float*>(vectors);
  p.n_rows = n_rows;
  p.m = m;
  p.cand_ids = static_cast<const int*>(cand_ids);
  p.cand_dists = static_cast<const float*>(cand_dists);
  p.queries = static_cast<const float*>(queries);
  p.v_ids = static_cast<const int*>(v_ids);
  p.sel_ids = static_cast<int*>(sel_ids);
  p.sel_dists = static_cast<float*>(sel_dists);
  p.ok = static_cast<uint8_t*>(ok);
  p.K = K;
  p.scheme = scheme;
  p.rng_checks = rng_checks;
  p.squared = squared;
  // mrng_occlusion's vec choice, so the sums run in the same order
  p.vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(vectors) % 16 == 0);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(W) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, extend_select_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
