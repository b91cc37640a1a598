// bag_lookup_bwd: the table's gradient of an embedding lookup and of a bag
// over the same ids, from the valid entries sorted by row
// (bag_bwd_order.cu):
//   grad_table[r] = sum over valid entries e = (b, f) with clip(ids[e],
//                   0, V-1) == r of  G[e, :] + w[e] * g[b, :]
// (dense, V x E float32; zero on a row no valid id names).  G (B*F, E) is
// the cotangent of the gathered rows (DIN's history, models/embedding_bag
// .py::HistoryRows) and g (B, E) the bag's (w = 1 where no weights are
// given); either may be absent.  An invalid entry is never read.
//
// Replaces no TPU kernel: with bag_bwd_order.cu it takes the role of JAX's
// autodiff of DIN's history (src/repro/models/recsys.py:212-220: one
// lookup, hist, whose table gradient is one scatter of dhist + w * g over
// the history's ids).  Contract: kernels/bag_lookup/ref.py
// (table_grad_ref).
//
// Bound on the H100: bytes (the sorted keys, positions and weights, each
// valid entry's G row and g read, grad_table written once).  The G rows
// are read in row order, so from random places: 72 bytes a row at DIN's
// E = 18, three 32-byte sectors.  Design, deterministic: no float atomics.
// * grad_table is zeroed by one memset (coalesced);
// * chunk pass: one warp a chunk of `chunk` sorted positions, columns
//   [c0, c0 + 32) of the rows a column group (blockIdx.y).  The warp
//   takes its chunk in rounds of 32 entries, two rounds in flight: lane j
//   reads entry j's key, position and weight a round ahead, and the
//   round's G and g rows are copied to shared memory by cp.async, every
//   lane on (entry, column pair) pieces of the flattened rows, so a warp
//   reads whole 72-byte rows one after the other and keeps many reads in
//   flight while it sums the round before.  Lane col < E walks a round in
//   order and adds each entry's G + w * g (an unfused multiply and add, as
//   the plain version rounds them) into column col of its row's run.  A
//   row wholly inside the chunk is written straight to grad_table; a row
//   that crosses the chunk's start leaves its sum in the chunk's partial
//   slot 0, one that crosses its end (and starts after the chunk's start)
//   in slot 1.  The chunk where a crossing row starts lists itself as the
//   row's owner; the chunk where it ends records itself in last[row].
// * combine pass: each owner adds the row's partials (its own slot, then
//   slot 0 of each later chunk up to last[row]) in one fixed order: K =
//   kCombine / Ec groups (Ec the group's columns, at most 32), group k
//   adding partials k, k + K, ... in turn from 0, then the groups' sums
//   added in group order.  A warp computes it for a row of at most kSmall
//   partials (each group holds at most one: the partials in turn, then the
//   empty groups' +0), the whole block, kAhead loads ahead a group, for a
//   longer one.  DIN's Zipf head (845,800 entries on row 0, a quarter of
//   the valid ones) is spread over some 3,300 chunks and combined by 56
//   groups.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kRound = 32;         // entries a warp stages at a time
constexpr int kCombine = 1024;     // threads of the combine pass
constexpr int kSmall = 16;         // partials a warp of it adds alone
constexpr int kAhead = 8;          // partials a combine group loads ahead

// One round's staging area in shared memory: Ec columns of kRound rows of
// G and of g, and the round's keys and weights.
struct Round {
  float* G;
  float* g;
  int* key;
  float* w;
};

__device__ __forceinline__ Round round_at(float* base, int Ec) {
  return {base, base + kRound * Ec,
          reinterpret_cast<int*>(base + 2 * kRound * Ec),
          base + 2 * kRound * Ec + kRound};
}

// Entry t0 + lane's key, position and weight (key -1 past hi).
struct Meta {
  int key, pos;
  float w;
};

__device__ __forceinline__ Meta load_meta(const int* __restrict__ keys,
                                          const int* __restrict__ pos,
                                          const float* __restrict__ ws,
                                          long long t0, long long hi,
                                          int lane) {
  Meta m{-1, 0, 1.f};
  if (t0 + lane < hi) {
    m.key = __ldg(keys + t0 + lane);
    m.pos = __ldg(pos + t0 + lane);
    if (ws != nullptr) m.w = __ldg(ws + t0 + lane);
  }
  return m;
}

// Start the copies of a round of m entries into r: every lane takes the
// (entry, piece) pairs lane, lane + 32, ... of the round's rows, in pieces
// of kPiece floats; then one commit.
template <int kPiece>
__device__ __forceinline__ void stage_round(Round r, Meta me, int m,
                                            int lane,
                                            const float* __restrict__ G,
                                            const float* __restrict__ g,
                                            int F, int E, int c0, int Ec) {
  if (lane < m) {
    r.key[lane] = me.key;
    r.w[lane] = me.w;
  }
  const int H = Ec / kPiece;                   // pieces an entry's row
  const int n = m * H;
  for (int f0 = 0; f0 < n; f0 += 32) {         // the same on every lane
    const int f = f0 + lane;
    const int j = min(f / H, kRound - 1), k = f - j * H;
    const int p = __shfl_sync(repro::kFullMask, me.pos, j);
    if (f < n) {
      const long long col = c0 + static_cast<long long>(k) * kPiece;
      if (G != nullptr)
        repro::cp_async<kPiece * 4>(r.G + f * kPiece,
                                    G + static_cast<long long>(p) * E + col);
      if (g != nullptr)
        repro::cp_async<kPiece * 4>(
            r.g + f * kPiece, g + static_cast<long long>(p / F) * E + col);
    }
  }
  repro::cp_async_commit();
}

__device__ __forceinline__ void flush(int row, long long seg, long long lo,
                                      bool row_starts_in, bool row_ends_in,
                                      int E, int col, float acc, long long c,
                                      float* __restrict__ partial,
                                      float* __restrict__ grad_table) {
  if ((seg > lo || row_starts_in) && row_ends_in) {
    grad_table[static_cast<long long>(row) * E + col] = acc;
  } else {
    partial[(c * 2 + (seg == lo ? 0 : 1)) * E + col] = acc;
  }
}

template <int kPiece>
__global__ void __launch_bounds__(128)
bwd_chunks(const int* __restrict__ keys, const int* __restrict__ pos,
           const float* __restrict__ ws, const int* __restrict__ count,
           const float* __restrict__ G, const float* __restrict__ g, int F,
           int E, int chunk, float* __restrict__ partial,
           float* __restrict__ grad_table, int* __restrict__ owners,
           int* __restrict__ n_owners, int* __restrict__ last) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * 32, Ec = min(32, E - c0);
  const int per_round = 2 * kRound * Ec + 2 * kRound;
  float* mine = smem + warp * 2 * per_round;
  const Round bufs[2] = {round_at(mine, Ec), round_at(mine + per_round, Ec)};
  const long long n = *count;
  const long long c =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const long long lo = c * chunk;
  if (lo >= n) return;                        // warp-uniform
  const long long hi = min(lo + chunk, n);
  // does the chunk's first row start at lo; does its last row end at hi?
  const int first = __ldg(keys + lo);
  const bool first_starts = lo == 0 || __ldg(keys + lo - 1) != first;
  const bool last_ends = hi == n || __ldg(keys + hi) != __ldg(keys + hi - 1);
  const int col = c0 + lane;
  float acc = 0.f;
  int row = first;
  long long seg = lo;
  const int rounds = static_cast<int>((hi - lo + kRound - 1) / kRound);
  Meta next = load_meta(keys, pos, ws, lo, hi, lane);
  stage_round<kPiece>(bufs[0], next,
                      static_cast<int>(min(hi - lo, 32LL)), lane, G, g, F,
                      E, c0, Ec);
  next = load_meta(keys, pos, ws, lo + kRound, hi, lane);
  for (int r = 0; r < rounds; ++r) {
    const long long t0 = lo + static_cast<long long>(r) * kRound;
    const int m = static_cast<int>(min(static_cast<long long>(kRound),
                                       hi - t0));
    if (r + 1 < rounds) {
      stage_round<kPiece>(bufs[(r + 1) & 1], next,
                          static_cast<int>(min(hi - t0 - kRound, 32LL)),
                          lane, G, g, F, E, c0, Ec);
      next = load_meta(keys, pos, ws, t0 + 2 * kRound, hi, lane);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncwarp();
    const Round b = bufs[r & 1];
    // each entry's G + w * g, every lane on the flattened round, into G's
    // place
    if (g != nullptr) {
      for (int f = lane; f < m * Ec; f += 32) {
        const float v = __fmul_rn(b.w[f / Ec], b.g[f]);
        b.G[f] = G == nullptr ? __fadd_rn(0.f, v) : __fadd_rn(b.G[f], v);
      }
      __syncwarp();
    }
    if (lane < Ec) {
      for (int j0 = 0; j0 < m; j0 += kAhead) {
        int kk[kAhead];
        float vv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {    // read ahead, then add
          const int j = min(j0 + u, m - 1);
          kk[u] = b.key[j];
          vv[u] = b.G[j * Ec + lane];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (j0 + u >= m) break;
          if (kk[u] != row) {                 // the same on every walker
            flush(row, seg, lo, first_starts, true, E, col, acc, c, partial,
                  grad_table);
            row = kk[u];
            seg = t0 + j0 + u;
            acc = 0.f;
          }
          acc = __fadd_rn(acc, vv[u]);
        }
      }
    }
    __syncwarp();                             // before the buffer is reused
  }
  if (lane < Ec)
    flush(row, seg, lo, first_starts, last_ends, E, col, acc, c, partial,
          grad_table);
  if (lane == 0 && blockIdx.y == 0) {
    // the owner of a row that starts here and crosses the end
    if ((seg > lo || first_starts) && !last_ends)
      owners[atomicAdd(n_owners, 1)] = static_cast<int>(c);
    // the last chunk of a row that began before: the first row ends here
    if (!first_starts && (row != first || last_ends))
      last[first] = static_cast<int>(c);
  }
}

// A warp an owner (a chunk where a crossing row starts): a row of at most
// kSmall partials is added here, in turn (the K groups' order, each group
// holding at most one; the empty groups add +0); a longer one goes to the
// list of big owners.
__global__ void __launch_bounds__(256)
bwd_combine_small(const int* __restrict__ keys, const int* __restrict__ count,
                  int E, int chunk, const float* __restrict__ partial,
                  const int* __restrict__ owners,
                  const int* __restrict__ n_owners,
                  const int* __restrict__ last, int* __restrict__ big,
                  int* __restrict__ n_big, float* __restrict__ grad_table) {
  const int lane = threadIdx.x & 31;
  const long long o =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (o >= *n_owners) return;                 // warp-uniform
  const int cb = blockIdx.y * 32, Ec = min(32, E - cb);
  const long long n = *count;
  const long long c0 = owners[o];
  const long long lo = c0 * chunk, hi = min(lo + chunk, n);
  const int r = __ldg(keys + hi - 1);
  const int m = last[r] - static_cast<int>(c0) + 1;
  if (m > kSmall) {
    if (lane == 0 && blockIdx.y == 0) big[atomicAdd(n_big, 1)] = o;
    return;
  }
  if (lane >= Ec) return;
  const bool at_lo = __ldg(keys + lo) == r;
  const int col = cb + lane;
  float v[kSmall];
  v[0] = partial[(c0 * 2 + (at_lo ? 0 : 1)) * E + col];
#pragma unroll
  for (int i = 1; i < kSmall; ++i)
    v[i] = i < m ? partial[(c0 + i) * 2 * E + col] : 0.f;
  float t = __fadd_rn(0.f, v[0]);
#pragma unroll
  for (int i = 1; i < kSmall; ++i)
    if (i < m) t = __fadd_rn(t, v[i]);
  grad_table[static_cast<long long>(r) * E + col] = __fadd_rn(t, 0.f);
}

// The block an owner of more than kSmall partials at a time, K groups of
// Ec threads: group k adds partials k, k + K, ... in turn (kAhead loads
// ahead), then thread col < Ec adds the groups' sums in group order.
__global__ void __launch_bounds__(kCombine)
bwd_combine_big(const int* __restrict__ keys, const int* __restrict__ count,
                int E, int chunk, const float* __restrict__ partial,
                const int* __restrict__ owners,
                const int* __restrict__ last, const int* __restrict__ big,
                const int* __restrict__ n_big,
                float* __restrict__ grad_table) {
  __shared__ float red[kCombine];
  const int cb = blockIdx.y * 32, Ec = min(32, E - cb);
  const int K = kCombine / Ec;
  const int k = threadIdx.x / Ec, col = cb + threadIdx.x - k * Ec;
  const long long n = *count;
  for (int q = blockIdx.x; q < *n_big; q += gridDim.x) {  // block-uniform
    const long long c0 = owners[big[q]];
    const long long lo = c0 * chunk, hi = min(lo + chunk, n);
    const int r = __ldg(keys + hi - 1);
    const long long m = last[r] - c0 + 1;
    const bool at_lo = __ldg(keys + lo) == r;
    if (k < K) {
      // partial i: the owner's own slot for i = 0, slot 0 of chunk c0 + i
      // after it
      const float* p0 = partial + (c0 * 2 + (at_lo ? 0 : 1)) * E + col;
      const float* p = partial + c0 * 2 * E + col;
      float s = 0.f;
      long long i = k;
      for (; i + (kAhead - 1) * static_cast<long long>(K) < m;
           i += kAhead * static_cast<long long>(K)) {
        float v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long iu = i + u * static_cast<long long>(K);
          v[u] = iu == 0 ? p0[0] : p[iu * 2 * E];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) s = __fadd_rn(s, v[u]);
      }
      for (; i < m; i += K) s = __fadd_rn(s, i == 0 ? p0[0] : p[i * 2 * E]);
      red[threadIdx.x] = s;
    }
    __syncthreads();
    if (threadIdx.x < Ec) {
      float t = red[threadIdx.x];
      for (int q2 = 1; q2 < K; ++q2)
        t = __fadd_rn(t, red[q2 * Ec + threadIdx.x]);
      grad_table[static_cast<long long>(r) * E + cb + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

}  // namespace

// keys, pos (n,) int32 and ws (n,) float32 or null: bag_bwd_order's
// sorted entries, the first *count of them valid; G (n, E) or null and g
// (n / F, E) or null, float32, in entry order; scratch: partial (2 *
// ceil(n / chunk) * E,) float32, owners and big (ceil(n / chunk),),
// n_owners and n_big (1,) and last (V,) int32; grad_table (V, E) float32.
// The wrapper launches nothing for E = 0.
REPRO_EXPORT int bag_lookup_bwd_f32(const void* keys, const void* pos,
                                    const void* ws, const void* count,
                                    long long n, const void* G, const void* g,
                                    int F, long long V, int E, int chunk,
                                    void* partial, void* owners, void* big,
                                    void* n_owners, void* last,
                                    void* grad_table, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaMemsetAsync(
      grad_table, 0, static_cast<size_t>(V) * E * sizeof(float), s));
  // n_owners and n_big, side by side
  if (rc == 0) rc = static_cast<int>(cudaMemsetAsync(n_owners, 0, 8, s));
  if (rc != 0 || n == 0 || E == 0 || (G == nullptr && g == nullptr))
    return rc;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const unsigned groups = static_cast<unsigned>((E + 31) / 32);
  // float2 pieces where every group's columns start 8-byte aligned
  const bool pairs = E % 2 == 0 && (reinterpret_cast<uintptr_t>(G) |
                                    reinterpret_cast<uintptr_t>(g)) % 8 == 0;
  const int Ec = std::min(E, 32);
  const size_t per_warp = 2 * (2 * kRound * Ec + 2 * kRound) * sizeof(float);
  const int warps = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(4, 45056 / per_warp)));
  const dim3 grid(static_cast<unsigned>((n_chunks + warps - 1) / warps),
                  groups);
  const auto* k = static_cast<const int*>(keys);
  const auto* cnt = static_cast<const int*>(count);
  const auto* pp = static_cast<const int*>(pos);
  const auto* wp = static_cast<const float*>(ws);
  const auto* Gp = static_cast<const float*>(G);
  const auto* gp = static_cast<const float*>(g);
  auto* part = static_cast<float*>(partial);
  auto* own = static_cast<int*>(owners);
  auto* n_own = static_cast<int*>(n_owners);
  auto* lst = static_cast<int*>(last);
  auto* out = static_cast<float*>(grad_table);
  if (pairs) {
    bwd_chunks<2><<<grid, warps * 32, warps * per_warp, s>>>(
        k, pp, wp, cnt, Gp, gp, F, E, chunk, part, out, own, n_own, lst);
  } else {
    bwd_chunks<1><<<grid, warps * 32, warps * per_warp, s>>>(
        k, pp, wp, cnt, Gp, gp, F, E, chunk, part, out, own, n_own, lst);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  auto* bg = static_cast<int*>(big);
  bwd_combine_small<<<dim3(static_cast<unsigned>((n_chunks + 7) / 8),
                           groups), 256, 0, s>>>(
      k, cnt, E, chunk, part, own, n_own, lst, bg, n_own + 1, out);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_combine_big<<<dim3(256, groups), kCombine, 0, s>>>(
      k, cnt, E, chunk, part, own, lst, bg, n_own + 1, out);
  return static_cast<int>(cudaGetLastError());
}
