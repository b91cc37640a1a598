// beam_search: the whole range search of the beam engine (paper Alg. 1,
// core/beam.py::beam_search) in one launch.  Each query lane repeats the
// composed hop (radius, select, adjacency gather, dedup, score, visited
// insert, merge) until it has no active selection or has looped max_hops
// times, and returns its final beam state.  The rows are float32, fp16 or
// bf16 vectors (a half row upcast to float32 in repro::row_sq_l2), the
// sq8 store's int8 code rows with their (m,) float32 scale,
// or the pq store's uint8 code rows scored through the lane's
// sub-distance table.  The fused preset runs here too: its hop is the
// composed hop with the visited filter (core/beam.py::expand).
//
// Replaces, on this path, the Pallas TPU kernels
// src/repro/kernels/beam_merge/beam_merge.py::beam_merge_pallas (:189),
// src/repro/kernels/gather_dist/gather_dist.py::gather_dist_pallas (:35),
// src/repro/kernels/gather_dist_q/gather_dist_q.py::gather_dist_q_pallas
// (:37), src/repro/kernels/pq_adc/pq_adc.py::pq_adc_pallas (:68) and
// src/repro/kernels/fused_hop/fused_hop.py::fused_hop_pallas (:114),
// together with the loop around them, src/repro/core/beam.py:351-408
// (one lax.while_loop of expand and alive).  Contract:
// kernels/beam_search/ref.py.
//
// Bound on the H100: each lane's chain of dependent steps.  A hop cannot
// start before the previous merge, and within a hop the adjacency row, the
// vector rows and the merge follow one another, so a lane spends a few
// device-memory latencies and about a dozen block barriers a hop, far
// above the bytes the search moves (the scored rows, the adjacency rows,
// the beam in and out), which is the bound reported beside it.
//
// Design: one block of 8 warps per lane, for the whole search.  The beam
// (ids, dists, checked and excluded flags, two copies that the merge
// writes in turn), the query, the E * d candidates of a hop, the exclude
// list, the visited table, over the sq8 store the scale, and over the pq
// store the lane's (m_sub, 256) table stay in shared memory throughout.  The pq table is built once, at
// the start of the search, by pq_adc's device function; pq_adc rebuilds
// it on every hop.  A hop:
//   1. one warp finds the radius (the k-th valid, non-excluded entry) and
//      the E first unchecked entries with ballots and prefix counts, and
//      marks the active ones checked;
//   2. each thread takes positions e * d + j: the adjacency entry and its
//      valid flag;
//   3. the dedup of core/beam.py::expand: the beam broadcast (against the
//      beam as it stood at the start of the hop) without the visited set,
//      the set's probes with it, and the first occurrence when E > 1;
//   4. one warp per surviving position scores its row with
//      repro::row_sq_l2 (an sq8 code row: repro::row_sq_l2_q8; a pq code
//      row: repro::pq_row_sum) and finish_dist, the device functions of
//      gather_dist, gather_dist_q and pq_adc, with their vec choices, so
//      distances are bit-identical to the host loop's;
//   5. the visited insert of core/visited.py::insert: P rounds of read,
//      claim by atomicMax (= scatter-amax, since INVALID is -1), re-read,
//      with a barrier between each, so tables come out bit-identical;
//   6. the merge of beam_merge: each entry counts the entries that precede
//      it in (dist, position) order, NaN last, and goes to that slot if it
//      is below L.
// Nothing returns to the host between hops, so the launch can be captured
// in a CUDA graph.  A lane that stops early leaves its SM to other lanes.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may use

// flag bits of a candidate position
constexpr uint8_t kValid = 1, kOk = 2, kKeep = 4, kExc = 8, kNeed = 16,
                  kClaim = 32;

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

// Byte offsets of the shared-memory sections, each 16-byte aligned.
// kernels/beam_search/ops.py::smem_bytes repeats this sum.
struct Layout {
  size_t misc, q, scale, lut, keys[2], bid[2], nid, ex, vis, sel_pos, sel_id,
      bchk[2], bexc[2], cflag, sel_act, total;
};

// m_sub: the pq store's subspaces, 0 for other rows (no table); sq8: the
// rows are sq8 codes, whose (m,) scale is staged beside the query.
__host__ __device__ inline Layout make_layout(int m, int L, int C, int X,
                                              int V, int E, int m_sub,
                                              bool sq8) {
  Layout o;
  size_t at = 0;
  const int T = L + C;
  o.misc = take(at, 16);
  o.q = take(at, 4 * static_cast<size_t>(m));
  o.scale = take(at, sq8 ? 4 * static_cast<size_t>(m) : 0);
  o.lut = take(at, 4 * static_cast<size_t>(m_sub) * repro::kPqStride);
  for (int s = 0; s < 2; ++s) o.keys[s] = take(at, 4 * static_cast<size_t>(T));
  for (int s = 0; s < 2; ++s) o.bid[s] = take(at, 4 * static_cast<size_t>(L));
  o.nid = take(at, 4 * static_cast<size_t>(C));
  o.ex = take(at, 4 * static_cast<size_t>(X));
  o.vis = take(at, 4 * static_cast<size_t>(V));
  o.sel_pos = take(at, 4 * static_cast<size_t>(E));
  o.sel_id = take(at, 4 * static_cast<size_t>(E));
  for (int s = 0; s < 2; ++s) o.bchk[s] = take(at, L);
  for (int s = 0; s < 2; ++s) o.bexc[s] = take(at, L);
  o.cflag = take(at, C);
  o.sel_act = take(at, E);
  o.total = at;
  return o;
}

struct Params {
  const int* adjacency;
  long long adj_rows;
  int deg;
  const void* rows;
  long long n_rows;
  int m;                   // the query's width
  const float* scale;      // (m,), sq8 rows only
  const float* codebooks;  // (m_sub, 256, dsub), pq rows only
  int m_sub, dsub;         // m_sub = 0 for vector rows
  const float* queries;
  const int* exclude;
  int X;
  const float* in_d;
  const int* in_i;
  const uint8_t* in_c;
  const uint8_t* in_x;
  const int* in_hops;
  const int* in_evals;
  const int* in_vis;
  const int* budget;  // null: no budget
  float* out_d;
  int* out_i;
  uint8_t* out_c;
  uint8_t* out_x;
  int* out_hops;
  int* out_evals;
  int* out_vis;
  int L, E, k, V, n_probes, n_valid, max_hops, squared, vec;
  float eps1;
};

// Row: float, __half or __nv_bfloat16 (vector rows of m), signed char
// (sq8 code rows of m), or uint8_t (pq code rows of m_sub bytes).
template <typename Row>
__global__ void __launch_bounds__(kThreads) beam_search_kernel(const Params p) {
  constexpr bool kPq = std::is_same_v<Row, uint8_t>;
  constexpr bool kSq8 = std::is_same_v<Row, signed char>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, E = p.E, deg = p.deg, C = E * deg, T = L + C;
  const int m = p.m, X = p.X, V = p.V;
  const Layout lay = make_layout(m, L, C, X, V, E, p.m_sub, kSq8);
  // misc: [0] the hop's bound r * eps1, [1] its active selections, [2]
  // its scored positions
  float* misc_f = reinterpret_cast<float*>(smem + lay.misc);
  int* misc_i = reinterpret_cast<int*>(smem + lay.misc);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  [[maybe_unused]] float* scale_s = reinterpret_cast<float*>(smem + lay.scale);
  [[maybe_unused]] float* lut = reinterpret_cast<float*>(smem + lay.lut);
  // the beam's two copies: the merge reads copy cur and writes the other
  // (selected, not indexed, so that no array goes to the stack)
  auto keys = [&](int c) {
    return reinterpret_cast<float*>(smem + (c ? lay.keys[1] : lay.keys[0]));
  };
  auto bid = [&](int c) {
    return reinterpret_cast<int*>(smem + (c ? lay.bid[1] : lay.bid[0]));
  };
  auto bchk = [&](int c) { return smem + (c ? lay.bchk[1] : lay.bchk[0]); };
  auto bexc = [&](int c) { return smem + (c ? lay.bexc[1] : lay.bexc[0]); };
  int* nid_s = reinterpret_cast<int*>(smem + lay.nid);
  int* ex_s = reinterpret_cast<int*>(smem + lay.ex);
  int* vis_s = reinterpret_cast<int*>(smem + lay.vis);
  int* sel_pos = reinterpret_cast<int*>(smem + lay.sel_pos);
  int* sel_id = reinterpret_cast<int*>(smem + lay.sel_id);
  uint8_t* cflag = smem + lay.cflag;
  uint8_t* sel_act = smem + lay.sel_act;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const float inf = CUDART_INF_F;
  const Row* rows = static_cast<const Row*>(p.rows);
  const unsigned vmask = static_cast<unsigned>(V - 1);

  for (int i = tid; i < m; i += kThreads) q_s[i] = p.queries[b * m + i];
  if constexpr (kSq8) {
    for (int i = tid; i < m; i += kThreads) scale_s[i] = p.scale[i];
  }
  for (int i = tid; i < L; i += kThreads) {
    keys(0)[i] = p.in_d[b * L + i];
    bid(0)[i] = p.in_i[b * L + i];
    bchk(0)[i] = p.in_c[b * L + i];
    bexc(0)[i] = p.in_x[b * L + i];
  }
  for (int i = tid; i < X; i += kThreads) ex_s[i] = p.exclude[b * X + i];
  for (int i = tid; i < V; i += kThreads) vis_s[i] = p.in_vis[b * V + i];
  int hops = p.in_hops[b], evals = p.in_evals[b];
  const bool has_budget = p.budget != nullptr;
  const int budget = has_budget ? p.budget[b] : 0;
  __syncthreads();
  if constexpr (kPq) {   // the lane's table, once for the whole search
    repro::pq_build_lut(lut, q_s, p.codebooks, p.m_sub, p.dsub);
    __syncthreads();
  }

  int cur = 0;
  for (int it = 0; it < p.max_hops; ++it) {
    float* kd = keys(cur);
    int* bi = bid(cur);
    uint8_t* bc = bchk(cur);
    uint8_t* bx = bexc(cur);

    // 1. radius, selection, activity: one warp
    if (warp == 0) {
      float r = inf;
      int cnt = 0;
      for (int base = 0; base < L; base += 32) {
        const int i = base + lane;
        const bool counted = i < L && bi[i] != repro::kInvalid && !bx[i];
        const unsigned bal = __ballot_sync(repro::kFullMask, counted);
        const int need = p.k - cnt;
        if (__popc(bal) >= need) {      // the k-th counted entry is here
          const int upto = __popc(bal & (repro::kFullMask >> (31 - lane)));
          const unsigned hit =
              __ballot_sync(repro::kFullMask, counted && upto == need);
          const float di = i < L ? kd[i] : inf;
          r = __shfl_sync(repro::kFullMask, di, __ffs(hit) - 1);
          break;
        }
        cnt += __popc(bal);
      }
      const float bound = __fmul_rn(r, p.eps1);   // a float32 product
      int got = 0;
      for (int base = 0; base < L && got < E; base += 32) {
        const int i = base + lane;
        const bool open = i < L && !bc[i];
        const unsigned bal = __ballot_sync(repro::kFullMask, open);
        const int slot = got + __popc(bal & ((1u << lane) - 1u));
        if (open && slot < E) sel_pos[slot] = i;
        got += __popc(bal);
      }
      __syncwarp();
      int nact = 0;
      for (int e0 = 0; e0 < E; e0 += 32) {
        const int e = e0 + lane;
        bool act = false;
        if (e < E) {
          // past the last unchecked entry the host loop selects position
          // 0, never active
          const bool un = e < got;
          const int pos = un ? sel_pos[e] : 0;
          const int sid = bi[pos];
          act = un && kd[pos] <= bound && sid != repro::kInvalid &&
                (!has_budget || hops < budget);
          sel_id[e] = sid;
          sel_act[e] = act;
          if (act) bc[pos] = 1;
        }
        nact += __popc(__ballot_sync(repro::kFullMask, act));
      }
      if (lane == 0) {
        misc_f[0] = bound;
        misc_i[1] = nact;
        misc_i[2] = 0;
      }
    }
    __syncthreads();
    const int nact = misc_i[1];
    if (nact == 0) break;   // a hop without an active selection is a no-op
    const float bound = misc_f[0];
    hops += nact;

    // 2. adjacency rows of the active selections.  nid_s holds the id of a
    // valid position and first_occurrence_mask's sentinel -(q + 2) of any
    // other, which never equals a valid id
    for (int q = tid; q < C; q += kThreads) {
      const int e = q / deg, j = q - e * deg;
      int tag = -(q + 2);
      uint8_t f = 0;
      if (sel_act[e]) {
        long long row = sel_id[e];
        row = row < 0 ? 0 : (row >= p.adj_rows ? p.adj_rows - 1 : row);
        const int nid = p.adjacency[row * deg + j];
        if (nid != repro::kInvalid && nid < p.n_valid) {
          tag = nid;
          f = kValid;
        }
      }
      nid_s[q] = tag;
      cflag[q] = f;
      kd[L + q] = inf;
    }
    __syncthreads();

    // 3. dedup against the hop-start beam or visited table
    for (int q = tid; q < C; q += kThreads) {
      if (!(cflag[q] & kValid)) continue;
      const int nid = nid_s[q];
      bool drop = false;
      if (E > 1) {
        for (int r2 = 0; r2 < q && !drop; ++r2) drop = nid_s[r2] == nid;
      }
      if (V > 0) {
        for (int t = 0; t < p.n_probes && !drop; ++t)
          drop = vis_s[repro::visited_probe(static_cast<unsigned>(nid), t,
                                            vmask)] == nid;
      } else {
        for (int i = 0; i < L && !drop; ++i) drop = bi[i] == nid;
      }
      if (!drop) cflag[q] = static_cast<uint8_t>(cflag[q] | kOk);
    }
    __syncthreads();

    // 4. score the survivors, one warp a position
    for (int q = warp; q < C; q += kWarps) {
      if (!(cflag[q] & kOk)) continue;   // uniform across the warp
      const int nid = nid_s[q];
      long long id = nid;
      id = id < 0 ? 0 : (id >= p.n_rows ? p.n_rows - 1 : id);
      float s;
      if constexpr (kPq) {
        s = repro::pq_row_sum(lut, rows + id * p.m_sub, p.m_sub, lane);
      } else if constexpr (kSq8) {
        s = repro::row_sq_l2_q8<true>(rows + id * m, scale_s, q_s, m,
                                      p.vec != 0, lane);
      } else {
        s = repro::row_sq_l2<true>(rows + id * m, q_s, m, p.vec != 0, lane);
      }
      if (lane == 0) {
        const float nd = repro::finish_dist(s, p.squared != 0);
        if (nd <= bound) {
          bool ex = false;
          for (int x = 0; x < X && !ex; ++x) ex = ex_s[x] == nid;
          cflag[q] = static_cast<uint8_t>(cflag[q] | kKeep | (ex ? kExc : 0));
          kd[L + q] = nd;
        }
        atomicAdd(&misc_i[2], 1);
      }
    }
    __syncthreads();
    evals += misc_i[2];

    // 5. visited insert of the scored ids (core/visited.py::insert)
    if (V > 0) {
      for (int q = tid; q < C; q += kThreads) {
        if (!(cflag[q] & kOk)) continue;
        const int nid = nid_s[q];
        bool present = false;
        for (int t = 0; t < p.n_probes; ++t)
          present |= vis_s[repro::visited_probe(static_cast<unsigned>(nid), t,
                                                vmask)] == nid;
        if (!present) cflag[q] = static_cast<uint8_t>(cflag[q] | kNeed);
      }
      for (int t = 0; t < p.n_probes; ++t) {
        for (int q = tid; q < C; q += kThreads) {
          uint8_t f = cflag[q];
          if (!(f & kNeed)) continue;
          const int nid = nid_s[q];
          const int v = vis_s[repro::visited_probe(static_cast<unsigned>(nid),
                                                   t, vmask)];
          if (v == nid) {
            f = static_cast<uint8_t>(f & ~kNeed);  // a duplicate placed it
          } else if (v == repro::kInvalid) {
            f = static_cast<uint8_t>(f | kClaim);
          }
          cflag[q] = f;
        }
        __syncthreads();
        for (int q = tid; q < C; q += kThreads) {
          if (!(cflag[q] & kClaim)) continue;
          const int nid = nid_s[q];
          atomicMax(&vis_s[repro::visited_probe(static_cast<unsigned>(nid), t,
                                                vmask)],
                    nid);
          cflag[q] = static_cast<uint8_t>(cflag[q] & ~kClaim);
        }
        __syncthreads();
        for (int q = tid; q < C; q += kThreads) {
          if (!(cflag[q] & kNeed)) continue;
          const int nid = nid_s[q];
          if (vis_s[repro::visited_probe(static_cast<unsigned>(nid), t,
                                         vmask)] == nid)
            cflag[q] = static_cast<uint8_t>(cflag[q] & ~kNeed);
        }
      }
      __syncthreads();   // the merge reads every position's flags
    }

    // 6. merge: the first L of the stable sort of [beam | candidates]
    const int nx = cur ^ 1;
    float* nkd = keys(nx);
    int* nbi = bid(nx);
    uint8_t* nbc = bchk(nx);
    uint8_t* nbx = bexc(nx);
    for (int i = tid; i < T; i += kThreads) {
      const float key = kd[i];
      int pos = 0;
      for (int j = 0; j < T; ++j) pos += repro::precedes(kd[j], j, key, i);
      if (pos >= L) continue;
      int id;
      uint8_t chk, exc;
      if (i < L) {
        id = bi[i];
        chk = bc[i];
        exc = bx[i];
      } else {
        const uint8_t f = cflag[i - L];
        id = (f & kKeep) ? nid_s[i - L] : repro::kInvalid;
        chk = 0;
        exc = (f & kExc) ? 1 : 0;
      }
      nkd[pos] = key;
      nbi[pos] = id;
      nbc[pos] = chk | (id == repro::kInvalid ? 1 : 0);
      nbx[pos] = exc;
    }
    __syncthreads();
    cur = nx;
  }

  for (int i = tid; i < L; i += kThreads) {
    p.out_d[b * L + i] = keys(cur)[i];
    p.out_i[b * L + i] = bid(cur)[i];
    p.out_c[b * L + i] = bchk(cur)[i];
    p.out_x[b * L + i] = bexc(cur)[i];
  }
  for (int i = tid; i < V; i += kThreads) p.out_vis[b * V + i] = vis_s[i];
  if (tid == 0) {
    p.out_hops[b] = hops;
    p.out_evals[b] = evals;
  }
}

template <typename Row>
int launch(const Params& p, int B, size_t smem, void* stream) {
  if (smem != make_layout(p.m, p.L, p.E * p.deg, p.X, p.V, p.E, p.m_sub,
                          std::is_same_v<Row, signed char>).total ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  static size_t opted_in = 48 * 1024;   // the default limit
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_search_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  beam_search_kernel<Row><<<B, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The vec choice of the per-hop kernel the host loop would run on these
// rows (gather_dist, gather_dist_q), from the same device pointers, so
// that the sums run in the same order; pq rows take none.
template <typename T>
int vec_choice(const void* rows, const void* scale, const void* queries,
               int m) {
  if constexpr (std::is_same_v<T, signed char>) {
    return repro::q8_vec(rows, scale, queries, m);
  } else {
    return (m % repro::per_load<T>() == 0) &&
           ((reinterpret_cast<uintptr_t>(rows) |
             reinterpret_cast<uintptr_t>(queries)) % 16 == 0);
  }
}

}  // namespace

// rows: (n_rows, m) float32, fp16 or bf16, for beam_search_sq8 (n_rows, m)
// int8
// codes with the (m,) float32 scale (null otherwise), or for
// beam_search_pq (n_rows, m_sub) uint8 codes with (m_sub, 256, dsub)
// float32 codebooks, m = m_sub * dsub (codebooks null and m_sub = dsub = 0
// otherwise); adjacency (adj_rows,
// deg) int32; queries (B, m) float32; exclude (B, X) int32; the state in
// (in_*) and out (out_*): dists (B, L) float32, ids (B, L) int32, checked
// and excluded (B, L) uint8 (torch.bool), hops and evals (B,) int32,
// visited (B, V) int32 with V a power of two, or null with V = 0; budget
// (B,) int32 or null.  smem_bytes must equal the kernel's own layout.
#define BEAM_SEARCH_ENTRY(NAME, T)                                           \
  REPRO_EXPORT int NAME(                                                     \
      const void* adjacency, long long adj_rows, int deg, const void* rows,  \
      long long n_rows, int m, const void* scale, const void* codebooks,     \
      int m_sub, int dsub,                                                   \
      const void* queries, const void* exclude, int X, const void* in_d,     \
      const void* in_i, const void* in_c, const void* in_x,                  \
      const void* in_hops, const void* in_evals,                             \
      const void* in_vis, const void* budget, void* out_d, void* out_i,      \
      void* out_c, void* out_x, void* out_hops, void* out_evals,             \
      void* out_vis, int B, int L, int E, int k, int V, int n_probes,        \
      int n_valid, int max_hops, int squared, float eps1,                    \
      long long smem_bytes, void* stream) {                                  \
    Params p;                                                                \
    p.adjacency = static_cast<const int*>(adjacency);                        \
    p.adj_rows = adj_rows;                                                   \
    p.deg = deg;                                                             \
    p.rows = rows;                                                           \
    p.n_rows = n_rows;                                                       \
    p.m = m;                                                                 \
    p.scale = static_cast<const float*>(scale);                              \
    p.codebooks = static_cast<const float*>(codebooks);                      \
    p.m_sub = m_sub;                                                         \
    p.dsub = dsub;                                                           \
    p.queries = static_cast<const float*>(queries);                          \
    p.exclude = static_cast<const int*>(exclude);                            \
    p.X = X;                                                                 \
    p.in_d = static_cast<const float*>(in_d);                                \
    p.in_i = static_cast<const int*>(in_i);                                  \
    p.in_c = static_cast<const uint8_t*>(in_c);                              \
    p.in_x = static_cast<const uint8_t*>(in_x);                              \
    p.in_hops = static_cast<const int*>(in_hops);                            \
    p.in_evals = static_cast<const int*>(in_evals);                          \
    p.in_vis = static_cast<const int*>(in_vis);                              \
    p.budget = static_cast<const int*>(budget);                              \
    p.out_d = static_cast<float*>(out_d);                                    \
    p.out_i = static_cast<int*>(out_i);                                      \
    p.out_c = static_cast<uint8_t*>(out_c);                                  \
    p.out_x = static_cast<uint8_t*>(out_x);                                  \
    p.out_hops = static_cast<int*>(out_hops);                                \
    p.out_evals = static_cast<int*>(out_evals);                              \
    p.out_vis = static_cast<int*>(out_vis);                                  \
    p.L = L;                                                                 \
    p.E = E;                                                                 \
    p.k = k;                                                                 \
    p.V = V;                                                                 \
    p.n_probes = n_probes;                                                   \
    p.n_valid = n_valid;                                                     \
    p.max_hops = max_hops;                                                   \
    p.squared = squared;                                                     \
    p.eps1 = eps1;                                                           \
    p.vec = vec_choice<T>(rows, scale, queries, m);                          \
    return launch<T>(p, B, static_cast<size_t>(smem_bytes), stream);         \
  }

BEAM_SEARCH_ENTRY(beam_search_f32, float)
BEAM_SEARCH_ENTRY(beam_search_f16, __half)
BEAM_SEARCH_ENTRY(beam_search_bf16, __nv_bfloat16)
BEAM_SEARCH_ENTRY(beam_search_sq8, signed char)
BEAM_SEARCH_ENTRY(beam_search_pq, uint8_t)
