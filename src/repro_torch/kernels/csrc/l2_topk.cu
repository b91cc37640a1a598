// l2_topk: for each query q_b the k rows x_i of the base with the smallest
// max(|q_b|^2 - 2 q_b.x_i + |x_i|^2, 0) (its sqrt unless squared), sorted
// ascending by (distance, id): ties go to the lower id.
//
// Replaces the Pallas TPU kernel src/repro/kernels/l2_topk/l2_topk.py::
// l2_topk_pallas (grid (B/TB, N/TN) with N innermost and the running top-k
// carried in VMEM scratch from one base tile to the next; base padded to
// whole tiles with rows of 1e19, dims to 128 lanes).  Contract:
// kernels/l2_topk/ref.py.
//
// Bound on the H100: operations at any real B.  2 B N m flops of float32
// dot products against (B + N) m floats read once; at the ground truth's
// B=10,000, N=53,387, m=192 that is 2.05e11 flops (3.06 ms at 67 TFLOP/s)
// against 49 MB (0.015 ms at 3.35 TB/s); a single query (B=1) is bound by
// its 41 MB of rows instead.  The reference is full float32, so the
// products are plain FP32 FMAs: no tensor cores, no TF32.
//
// Design.  The TPU's sequential N axis is cut into S tile-aligned row
// ranges ("splits"), chosen in Python (kernels/l2_topk/ops.py::
// plan_splits) so that ceil(B / TQ) x S blocks fill the card: a block owns
// TQ queries and one split, whatever B is.  Three block shapes of 256
// threads, the widest that takes (B, k): Wide (TQ=128 queries x TN=128
// rows a tile, an 8 x 8 register tile a thread; k <= 32, B >= 4096), Mid
// (32 x 128, 4 x 4; k <= 256, B >= 32), Narrow (8 x 256, 8 x 1; the rest,
// k <= 2048).  A wider tile reads the base fewer times (B / TQ passes over
// it); a narrower one leaves each warp fewer lists to keep.  Per tile the
// (TQ, TN) dot products run over chunks of KC=32 dims: queries and rows
// are staged row-major in two shared-memory buffers by cp.async (16-byte
// copies where m % 4 == 0 and the operands are 16-byte aligned, 4-byte
// ones otherwise; the ragged edges are zero-filled by the copy's source
// size), so the next chunk loads while this one's FMAs run.  Each thread
// reads its queries and rows as float4 along the dims (a row pitch of 36
// floats puts a quarter-warp's rows on distinct banks; the queries are
// warp broadcasts) and does RQ x RN x 4 FMAs per RQ + RN 16-byte loads.
// Row norms are summed from the same staged chunks.  The (TQ, TN)
// distance tile goes to shared memory, never to device memory; then one
// warp per query merges its tile row into the query's running top-k, a
// list sorted by (distance, id) in shared memory.  An empty list takes the
// k best of the row at once (a bitonic sort of the row in registers).
// Later rows pass only entries that beat the list's last: a few are
// inserted one at a time (a ballot count gives the position; lists of
// k <= 128 are held in registers across the row), many (k > 32) are
// compacted, sorted and merged by merge-path in one step.  A block writes
// its split's k best to a (B, S, k) workspace, padded with (+inf, -1)
// where the split holds fewer than k rows; a second kernel merges the S
// lists of each query by a tree of pairwise merge-path merges in shared
// memory (S * k <= 4096), a block of 8 warps a query for B <= 512, a warp
// a query above.  With S = 1 the scan writes the output directly and no
// merge runs.  Every kernel's dynamic shared-memory limit is raised once
// per process, so a call can be captured in a CUDA graph.
//
// A pair's distance does not depend on the block, split or tile position
// that computes it: every pair's dot product is one FMA chain over dims
// 0..m-1 in order, a query's norm is one warp sum, and a row's norm is the
// in-order sum of 8 partials, partial w over dims w, w + 8, ... in order.
// So the output is bit-identical for every S and every block shape (and
// to this kernel's first, unsplit version, which summed in the same
// orders).  The ragged edges are masked: rows >= N never enter a list,
// dims >= m load as 0, and nothing is padded in device memory.  Ids are
// int32 (N < 2^31).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 2048;            // kernels/l2_topk/ops.py MAX_K
constexpr int kMaxSplits = 256;        // ops.py MAX_SPLITS
constexpr int kMergeEntries = 4096;    // ops.py MERGE_ENTRIES: S * k
constexpr int kMergeWideMaxB = 512;    // up to this B a query's merge
                                       // takes a block of 8 warps
constexpr int kMaxSmem = 232448;       // a block's dynamic shared memory
constexpr int kBulkMaxK = 256;         // ops.py BULK_MAX_K
constexpr int kBulkMin = 4;            // passing entries that take bulk_row
constexpr int kNormParts = 8;          // a row norm's partials, by dim mod 8
constexpr int kKC = 32;                // dims a staged chunk holds
constexpr int kPitch = kKC + 4;        // floats a staged row: 16-byte
                                       // aligned, and a quarter-warp's
                                       // rows fall on distinct banks
constexpr int kStages = 2;             // chunks staged at once

// (d, i) < (e, j) in the (distance, id) order
__device__ __forceinline__ bool key_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// the tile column of a lane's r-th entry of a tile row (float4 reads)
__device__ __forceinline__ int tile_col(int r, int lane) {
  return (r >> 2) * 128 + lane * 4 + (r & 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy 16 (or 4) bytes to shared memory; bytes past src_bytes are zeroed
// and src_bytes = 0 reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block shape: TQ queries x TN rows a tile, RQ x RN outputs a thread,
// threads laid out TY x TX; thread (ty, tx) owns queries ty + TY i and rows
// tx + TX j of the tile.
template <int TQ_, int TN_, int RQ_, int RN_, int MIN_BLOCKS_>
struct Shape {
  static constexpr int TQ = TQ_, TN = TN_, RQ = RQ_, RN = RN_;
  static constexpr int TY = TQ / RQ, TX = TN / RN;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static_assert(TY * TX == kThreads, "one register tile a thread");
  static_assert(TN % 128 == 0, "a lane merges float4s of a tile row");
  static_assert(TY == 1 || TY % kNormParts == 0,
                "threads 0..7 of a row column keep its norm partials");
  static constexpr int kStageFloats = (TQ + TN) * kPitch;
  // mirrored by kernels/l2_topk/ops.py::smem_bytes
  static size_t smem_bytes(int k) {
    return sizeof(float) * (static_cast<size_t>(kStages) * kStageFloats
                            + static_cast<size_t>(TQ) * TN  // distance tile
                            + TN + TQ)                      // xn, qn
           + static_cast<size_t>(TQ) * k * (sizeof(float) + sizeof(int))
           + sizeof(int) * 3 * TQ                   // counts, thr, flag
           + (k <= kBulkMaxK ? sizeof(float) * 2 * kWarps * TN  // scratch
                             : 0);
  }
};
using Wide = Shape<128, 128, 8, 8, 1>;
using Mid = Shape<32, 128, 4, 4, 2>;
using Narrow = Shape<8, 256, 8, 1, 2>;
constexpr int kMaxKWide = 32;          // ops.py MAX_K_OF[128]
constexpr int kMaxKMid = 256;          // ops.py MAX_K_OF[32]

// Insert (d, id) into the sorted list (ld, li) of cnt <= k entries in
// shared memory (k > 128); one warp, every lane returns the new count.
__device__ __forceinline__ int warp_insert(float* ld, int* li, int cnt,
                                           int k, float d, int id,
                                           int lane) {
  int pos = 0;
  for (int t0 = 0; t0 < cnt; t0 += 32) {
    const int t = t0 + lane;
    pos += __popc(__ballot_sync(repro::kFullMask,
                                t < cnt && key_less(ld[t], li[t], d, id)));
  }
  const int new_cnt = cnt < k ? cnt + 1 : k;
  // shift [pos, new_cnt - 1) up by one, 32 entries at a time from the top:
  // a step's reads lie below every write of the steps before it
  for (int top = new_cnt - 2; top >= pos; top -= 32) {
    const int t = top - lane;
    float dv = 0.f;
    int iv = 0;
    const bool mine = t >= pos;
    if (mine) {
      dv = ld[t];
      iv = li[t];
    }
    __syncwarp();
    if (mine) {
      ld[t + 1] = dv;
      li[t + 1] = iv;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ld[pos] = d;
    li[pos] = id;
  }
  __syncwarp();
  return new_cnt;
}

// A query's running list held by one warp in registers for k <= 32 R:
// lane l holds entries l R .. l R + R - 1.  Loaded from and stored to the
// block's shared-memory list around the inserts of one tile row.
template <int R>
struct RegList {
  float d[R > 0 ? R : 1];
  int id[R > 0 ? R : 1];
  float last_d;
  int last_i;

  __device__ __forceinline__ void load(const float* ld, const int* li,
                                       int cnt, int k, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane * R + r;
      d[r] = e < cnt ? ld[e] : INFINITY;
      id[r] = e < cnt ? li[e] : repro::kInvalid;
    }
    refresh_last(cnt, k);
  }

  __device__ __forceinline__ void store(float* ld, int* li, int cnt,
                                        int lane) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane * R + r;
      if (e < cnt) {
        ld[e] = d[r];
        li[e] = id[r];
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void refresh_last(int cnt, int k) {
    if (cnt < k) return;
    const int slot = (k - 1) % R;
    float v = d[0];
    int w = id[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
      if (r == slot) {
        v = d[r];
        w = id[r];
      }
    last_d = __shfl_sync(repro::kFullMask, v, (k - 1) / R);
    last_i = __shfl_sync(repro::kFullMask, w, (k - 1) / R);
  }

  // insert (cd, ci) if it beats the last of a full list; new count
  __device__ __forceinline__ int insert(float cd, int ci, int cnt, int k,
                                        int lane) {
    if (cnt == k && !key_less(cd, ci, last_d, last_i)) return cnt;
    int pos = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      pos += __popc(__ballot_sync(
          repro::kFullMask,
          lane * R + r < cnt && key_less(d[r], id[r], cd, ci)));
    // entry e takes old e - 1 above pos, the new key at pos
    const float up_d = __shfl_up_sync(repro::kFullMask, d[R - 1], 1);
    const int up_i = __shfl_up_sync(repro::kFullMask, id[R - 1], 1);
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int e = lane * R + r;
      const float od = r > 0 ? d[r > 0 ? r - 1 : 0] : up_d;
      const int oi = r > 0 ? id[r > 0 ? r - 1 : 0] : up_i;
      if (e > pos) {
        d[r] = od;
        id[r] = oi;
      } else if (e == pos) {
        d[r] = cd;
        id[r] = ci;
      }
    }
    cnt = cnt < k ? cnt + 1 : k;
    refresh_last(cnt, k);
    return cnt;
  }
};

// Sort the warp's 32 E keys ascending by (distance, id), E a lane (lane
// l holds ranks l E .. l E + E - 1 after), by a bitonic network in
// registers: pairs within a lane swap in place, pairs across lanes meet by
// __shfl_xor_sync.
template <int E>
__device__ __forceinline__ void warp_sort(float (&d)[E], int (&id)[E],
                                          int lane) {
  static_assert(E == 1 || E == 2 || E == 4 || E == 8, "E a power of two");
  constexpr int kLog = 5 + (E == 1 ? 0 : E == 2 ? 1 : E == 4 ? 2 : 3);
  // linear loop counters, so that both loops unroll and every slot index
  // below is a constant: a register, never local memory
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int s = 1 << ls, t = 1 << lt;
      if (t >= E) {  // partner in lane ^ (t / E), same slot
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const float pd = __shfl_xor_sync(repro::kFullMask, d[r], t / E);
          const int pi = __shfl_xor_sync(repro::kFullMask, id[r], t / E);
          const int i = lane * E + r;
          const bool up = (i & s) == 0, lower = (i & t) == 0;
          const bool less = key_less(d[r], id[r], pd, pi);
          if (lower == up ? !less : less) {
            d[r] = pd;
            id[r] = pi;
          }
        }
      } else {  // partner in this lane
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if (r & t) continue;
          const int r2 = r | t;
          const bool up = ((lane * E + r) & s) == 0;
          const bool swap = up ? key_less(d[r2], id[r2], d[r], id[r])
                               : key_less(d[r], id[r], d[r2], id[r2]);
          if (swap) {
            const float td = d[r];
            d[r] = d[r2];
            d[r2] = td;
            const int ti = id[r];
            id[r] = id[r2];
            id[r2] = ti;
          }
        }
      }
    }
  }
}

// The output at position o of merge(a[0:la], b[0:lb]), keys distinct: the
// merge-path search finds how many of the first o outputs come from a.
__device__ __forceinline__ void merge_path_at(const float* ad, const int* ai,
                                              int la, const float* bd,
                                              const int* bi, int lb, int o,
                                              float& vd, int& vi) {
  int lo = max(0, o - lb), hi = min(o, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(ad[mid], ai[mid], bd[o - mid - 1], bi[o - mid - 1]))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = lo, j = o - lo;
  const bool take_a = j >= lb || (i < la && key_less(ad[i], ai[i], bd[j], bi[j]));
  vd = take_a ? ad[i] : bd[j];
  vi = take_a ? ai[i] : bi[j];
}

// Sort the warp's scratch keys [0, P) in place, 32 ES slots (P <= 32 ES).
template <int ES>
__device__ __forceinline__ void sort_scratch(float* sc_d, int* sc_i, int P,
                                             int lane) {
  float d[ES];
  int id[ES];
#pragma unroll
  for (int r = 0; r < ES; ++r) {
    const int i = lane * ES + r;
    d[r] = i < P ? sc_d[i] : INFINITY;
    id[r] = i < P ? sc_i[i] : 0x7fffffff;
  }
  __syncwarp();
  warp_sort<ES>(d, id, lane);
#pragma unroll
  for (int r = 0; r < ES; ++r) {
    const int i = lane * ES + r;
    if (i < P) {
      sc_d[i] = d[r];
      sc_i[i] = id[r];
    }
  }
  __syncwarp();
}

// Merge the P entries of a tile row that pass (dd[r] at column
// tile_col(r), pass[r]) at once.  An empty list takes the first min(k, P)
// of the row sorted in registers.  Into a list of k <= kBulkMaxK they are
// compacted into the warp's scratch row, sorted there (a network of the
// next power of two of P), and merged by merge-path, each lane's output
// positions searched in lockstep, into its min(k, cnt + P) best.
template <int TN, int KOUT>
__device__ __noinline__ int bulk_row(float* ld, int* li, int cnt, int k,
                                        const float (&dd)[TN / 32],
                                        const bool (&pass)[TN / 32],
                                        long long r0, int P, float* sc_d,
                                        int* sc_i, int lane) {
  constexpr int E = TN / 32;
  if (cnt == 0) {  // sort the row in registers: no scratch for k > 256
    float d[E];
    int id[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      d[r] = pass[r] ? dd[r] : INFINITY;
      id[r] = pass[r] ? static_cast<int>(r0 + tile_col(r, lane)) : 0x7fffffff;
    }
    warp_sort<E>(d, id, lane);
    const int n = min(k, P);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int i = lane * E + r;
      if (i < n) {
        ld[i] = d[r];
        li[i] = id[r];
      }
    }
    __syncwarp();
    return n;
  }
  int base = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const unsigned b = __ballot_sync(repro::kFullMask, pass[r]);
    if (pass[r]) {
      const int pos = base + __popc(b & ((1u << lane) - 1));
      sc_d[pos] = dd[r];
      sc_i[pos] = static_cast<int>(r0 + tile_col(r, lane));
    }
    base += __popc(b);
  }
  __syncwarp();
  if (P <= 32) {
    sort_scratch<1>(sc_d, sc_i, P, lane);
  } else if (P <= 64) {
    sort_scratch<2>(sc_d, sc_i, P, lane);
  } else if (TN == 128 || P <= 128) {
    sort_scratch<4>(sc_d, sc_i, P, lane);
  } else if constexpr (TN > 128) {
    sort_scratch<8>(sc_d, sc_i, P, lane);
  }
  const int n = min(k, cnt + P);
  constexpr int kOut = KOUT;  // output positions a lane: k <= 32 KOUT
  int lo[kOut], hi[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int o = lane + 32 * j;
    lo[j] = max(0, o - P);
    hi[j] = o < n ? min(o, cnt) : lo[j];
  }
  // i of the first o outputs come from the list, o - i from the scratch
  for (int w = P; w > 0; w >>= 1) {  // ceil(log2(P + 1)) halvings
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (lo[j] < hi[j]) {
        const int o = lane + 32 * j, mid = (lo[j] + hi[j]) >> 1;
        if (key_less(ld[mid], li[mid], sc_d[o - mid - 1], sc_i[o - mid - 1]))
          lo[j] = mid + 1;
        else
          hi[j] = mid;
      }
    }
  }
  float od[kOut];
  int oi[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int o = lane + 32 * j, i = lo[j], c = o - lo[j];
    if (o < n) {
      const bool take_list =
          c >= P || (i < cnt && key_less(ld[i], li[i], sc_d[c], sc_i[c]));
      od[j] = take_list ? ld[i] : sc_d[c];
      oi[j] = take_list ? li[i] : sc_i[c];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kOut; ++j)
    if (lane + 32 * j < n) {
      ld[lane + 32 * j] = od[j];
      li[lane + 32 * j] = oi[j];
    }
  __syncwarp();
  return n;
}

// Merge one query's tile row (TN distances of rows r0 .. r0 + TN - 1) into
// its running list; returns the new count.  Lane l holds columns
// h * 128 + 4 l .. + 3 of the row.  An empty list, or kBulkMin or more
// passing entries where 32 < k <= kBulkMaxK, take bulk_row; the rest are
// inserted one by one, into a register list for k <= 32 R.
template <int TN, int R>
__device__ __forceinline__ int merge_row(float* ld, int* li, int cnt, int k,
                                         const float* row, long long r0,
                                         long long N, float* sc_d, int* sc_i,
                                         int lane) {
  constexpr int E = TN / 32;
  float dd[E];
#pragma unroll
  for (int h = 0; h < TN / 128; ++h) {
    const float4 v =
        *reinterpret_cast<const float4*>(row + h * 128 + lane * 4);
    dd[4 * h] = v.x;
    dd[4 * h + 1] = v.y;
    dd[4 * h + 2] = v.z;
    dd[4 * h + 3] = v.w;
  }
  float last_d = 0.f;
  int last_i = 0;
  if (cnt == k) {
    last_d = ld[k - 1];
    last_i = li[k - 1];
  }
  bool pass[E];
  int mine = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const long long g = r0 + tile_col(r, lane);
    pass[r] = g < N && !isnan(dd[r]) &&
              (cnt < k || key_less(dd[r], static_cast<int>(g), last_d, last_i));
    mine += pass[r];
  }
  const int P = __reduce_add_sync(repro::kFullMask, mine);
  if (P == 0) return cnt;
  if (cnt == 0 || (k > 32 && k <= kBulkMaxK && P >= kBulkMin))
    return bulk_row<TN, (R > 0 ? R : kBulkMaxK / 32)>(ld, li, cnt, k, dd,
                                                       pass, r0, P, sc_d,
                                                       sc_i, lane);
  RegList<R> list;
  if constexpr (R > 0) list.load(ld, li, cnt, k, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    unsigned want = __ballot_sync(repro::kFullMask, pass[r]);
    while (want) {
      const int src = __ffs(want) - 1;
      want &= want - 1;
      const float cd = __shfl_sync(repro::kFullMask, dd[r], src);
      const int ci = static_cast<int>(r0 + tile_col(r, src));
      if constexpr (R > 0) {
        cnt = list.insert(cd, ci, cnt, k, lane);
      } else {
        // the list may have moved since the pass flags
        if (cnt == k && !key_less(cd, ci, ld[k - 1], li[k - 1])) continue;
        cnt = warp_insert(ld, li, cnt, k, cd, ci, lane);
      }
    }
  }
  if constexpr (R > 0) list.store(ld, li, cnt, lane);
  return cnt;
}

// Block (query tile blockIdx.x, split blockIdx.y of S = gridDim.y): the k
// best rows of tiles [split * split_tiles, ...) for each of its queries,
// written to out[(b * S + split) * k ...] (with S = 1, the output itself).
template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
l2_topk_scan_kernel(const float* __restrict__ queries,
                    const float* __restrict__ base, int B, long long N,
                    int m, int k, int squared, int vec4,
                    long long split_tiles, float* __restrict__ out_d,
                    int* __restrict__ out_i) {
  constexpr int TQ = C::TQ, TN = C::TN, RQ = C::RQ, RN = C::RN;
  constexpr int TY = C::TY, TX = C::TX, KC = kKC, ST = kStages;
  constexpr int P = kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // ST x [TQ + TN][P]
  float* tile = ring + ST * C::kStageFloats;         // [TQ][TN]
  float* xn = tile + TQ * TN;                        // [TN]
  float* qn = xn + TN;                               // [TQ]
  float* list_d = qn + TQ;                           // [TQ][k]
  int* list_i = reinterpret_cast<int*>(list_d + TQ * k);  // [TQ][k]
  int* counts = list_i + TQ * k;                     // [TQ]
  float* thr = reinterpret_cast<float*>(counts + TQ);  // [TQ] list's last
  int* flag = reinterpret_cast<int*>(thr + TQ);      // [TQ] row may merge
  float* scratch_d = reinterpret_cast<float*>(flag + TQ);  // [kWarps][TN]
  int* scratch_i = reinterpret_cast<int*>(scratch_d + kWarps * TN);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const long long n_tiles = (N + TN - 1) / TN;
  const long long t_begin = split * split_tiles;
  const long long t_end = min(n_tiles, t_begin + split_tiles);
  const int m_chunks = (m + KC - 1) / KC * KC;  // m rounded up to chunks
  const long long n_steps = (t_end - t_begin) * (m_chunks / KC);

  // query norms, one warp per query
  for (int q = warp; q < TQ; q += kWarps) {
    float s = 0.f;
    if (q0 + q < B) {
      const float* row = queries + static_cast<long long>(q0 + q) * m;
      for (int c = lane; c < m; c += 32) s = fmaf(row[c], row[c], s);
    }
    s = repro::warp_sum(s);
    if (lane == 0) {
      qn[q] = s;
      counts[q] = 0;
      thr[q] = INFINITY;
      flag[q] = 0;
    }
  }

  // stage (tile at row r0, dims c0 ..) into ring slot: TQ query rows, then
  // TN base rows, KC dims each; out-of-range rows and dims are zero-filled
  auto load_chunk = [&](long long r0, int c0, int slot) {
    float* st = ring + slot * C::kStageFloats;
    if (vec4) {
      for (int u = tid; u < (TQ + TN) * (KC / 4); u += kThreads) {
        const int r = u / (KC / 4), cc = u % (KC / 4) * 4, c = c0 + cc;
        const float* src = queries;
        bool ok;
        if (r < TQ) {
          ok = q0 + r < B && c < m;
          if (ok) src = queries + static_cast<long long>(q0 + r) * m + c;
        } else {
          const long long g = r0 + (r - TQ);
          ok = g < N && c < m;
          if (ok) src = base + g * m + c;
        }
        cp_async16(st + r * P + cc, src, ok ? 16 : 0);
      }
    } else {
      for (int u = tid; u < (TQ + TN) * KC; u += kThreads) {
        const int r = u / KC, cc = u % KC, c = c0 + cc;
        const float* src = queries;
        bool ok;
        if (r < TQ) {
          ok = q0 + r < B && c < m;
          if (ok) src = queries + static_cast<long long>(q0 + r) * m + c;
        } else {
          const long long g = r0 + (r - TQ);
          ok = g < N && c < m;
          if (ok) src = base + g * m + c;
        }
        cp_async4(st + r * P + cc, src, ok ? 4 : 0);
      }
    }
  };

  float acc[RQ][RN];
  // a row's norm is the in-order sum of 8 partials, partial w over dims
  // w, w + 8, ... in order (the order of every block shape): a thread with
  // all of its rows' dims (TY == 1) keeps all 8, else thread ty < 8 keeps
  // partial ty of its rows
  constexpr int kParts = TY == 1 ? kNormParts : 1;
  float xnp[RN][kParts];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < RN; ++j)
#pragma unroll
    for (int u = 0; u < kParts; ++u) xnp[j][u] = 0.f;

  // the load cursor runs ST - 1 chunks ahead of the compute cursor; both
  // step through (tile, chunk) without a division
  long long ld_r0 = t_begin * TN;
  int ld_c = 0;
  int ld_slot = 0;
  auto issue = [&](long long step) {
    if (step < n_steps) load_chunk(ld_r0, ld_c, ld_slot);
    cp_async_commit();
    ld_slot = ld_slot + 1 == ST ? 0 : ld_slot + 1;
    ld_c += KC;
    if (ld_c == m_chunks) {
      ld_c = 0;
      ld_r0 += TN;
    }
  };
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) issue(p);

  long long r0 = t_begin * TN;
  int c = 0;
  int slot = 0;
  for (long long step = 0; step < n_steps; ++step) {
    cp_async_wait<ST - 2>();  // this step's chunk has landed
    __syncthreads();          // ... for every thread; the last step's reads
                              // of the slot refilled below are done
    issue(step + ST - 1);
    const float* qs = ring + slot * C::kStageFloats;
    const float* xs = qs + TQ * P;
    slot = slot + 1 == ST ? 0 : slot + 1;
#pragma unroll
    for (int g = 0; g < KC; g += 4) {
      float4 a[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + TY * i) * P + g);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(xs + (tx + TX * j) * P + g);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
        if constexpr (TY == 1) {  // dims g .. g + 3: partials g % 8 ..
          const int p = g % kNormParts;
          xnp[j][p] = fmaf(b.x, b.x, xnp[j][p]);
          xnp[j][p + 1] = fmaf(b.y, b.y, xnp[j][p + 1]);
          xnp[j][p + 2] = fmaf(b.z, b.z, xnp[j][p + 2]);
          xnp[j][p + 3] = fmaf(b.w, b.w, xnp[j][p + 3]);
        }
      }
    }
    if constexpr (TY > 1) {  // dims ty, ty + 8, ... of the chunk
      if (ty < kNormParts) {
#pragma unroll
        for (int j = 0; j < RN; ++j)
#pragma unroll
          for (int kk = 0; kk < KC; kk += kNormParts) {
            const float x = xs[(tx + TX * j) * P + kk + ty];
            xnp[j][0] = fmaf(x, x, xnp[j][0]);
          }
      }
    }
    c += KC;
    if (c < m_chunks) continue;

    // the tile's last chunk: row norms, distances, merge
    c = 0;
    if constexpr (TY == 1) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kNormParts; ++w) s += xnp[j][w];
        xn[tx + TX * j] = s;
      }
    } else {
      // the 8 partials of each row, in the tile's space, summed in order
      if (ty < kNormParts) {
#pragma unroll
        for (int j = 0; j < RN; ++j) tile[ty * TN + tx + TX * j] = xnp[j][0];
      }
      __syncthreads();
      for (int r = tid; r < TN; r += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kNormParts; ++w) s += tile[w * TN + r];
        xn[r] = s;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q = ty + TY * i;
      const float t = thr[q];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int r = tx + TX * j;
        // (|q|^2 - 2 q.x) + |x|^2, each step rounded on its own
        float d2 = __fadd_rn(__fsub_rn(qn[q], __fmul_rn(2.f, acc[i][j])),
                             xn[r]);
        d2 = fmaxf(d2, 0.f);
        const float d = squared ? d2 : sqrtf(d2);
        tile[q * TN + r] = d;
        hit |= d <= t;
        acc[i][j] = 0.f;
      }
      if (hit) flag[q] = 1;  // the query's row may hold a candidate
    }
#pragma unroll
    for (int j = 0; j < RN; ++j)
#pragma unroll
      for (int u = 0; u < kParts; ++u) xnp[j][u] = 0.f;
    __syncthreads();

    // merge: warp w owns queries w, w + 8, ...; a row no entry of which
    // reaches the list's last distance holds nothing to merge
    for (int q = warp; q < TQ; q += kWarps) {
      if (q0 + q >= B || !flag[q]) continue;  // warp-uniform
      float* ld = list_d + q * k;
      int* li = list_i + q * k;
      const float* row = tile + q * TN;
      float* sd = scratch_d + warp * TN;
      int* si = scratch_i + warp * TN;
      int cnt = counts[q];
      if (k <= 32)
        cnt = merge_row<TN, 1>(ld, li, cnt, k, row, r0, N, sd, si, lane);
      else if (k <= 64)
        cnt = merge_row<TN, 2>(ld, li, cnt, k, row, r0, N, sd, si, lane);
      else if (k <= 128)
        cnt = merge_row<TN, 4>(ld, li, cnt, k, row, r0, N, sd, si, lane);
      else
        cnt = merge_row<TN, 0>(ld, li, cnt, k, row, r0, N, sd, si, lane);
      if (lane == 0) {
        counts[q] = cnt;
        thr[q] = cnt == k ? ld[k - 1] : INFINITY;
        flag[q] = 0;
      }
      __syncwarp();
    }
    r0 += TN;
  }
  __syncthreads();

  for (int q = warp; q < TQ; q += kWarps) {
    const int b = q0 + q;
    if (b >= B) continue;
    const int cnt = counts[q];
    const long long o = (static_cast<long long>(b) * S + split) * k;
    for (int t = lane; t < k; t += 32) {
      const bool have = t < cnt;
      out_d[o + t] = have ? list_d[q * k + t] : INFINITY;
      out_i[o + t] = have ? list_i[q * k + t] : repro::kInvalid;
    }
  }
}

// Merge the S sorted lists of k entries of each query (padded with
// (+inf, -1) past their valid entries) into its k best: log2(S) levels of
// pairwise merges, each output position found by a merge-path search, in
// two shared-memory buffers.  W warps serve a query (8 for few queries, so
// that one query's levels spread over a block), Q queries a block.
template <int W, int Q>
__global__ void __launch_bounds__(W * Q * 32)
l2_topk_merge_kernel(const float* __restrict__ part_d,
                     const int* __restrict__ part_i, int B, int S, int k,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  static_assert(W == 1 || Q == 1, "a block barrier serves one query");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = W * 32;  // threads a query
  const int t = threadIdx.x % G;
  const int b = blockIdx.x * Q + threadIdx.x / G;
  const bool active = b < B;  // uniform over a query's threads
  auto sync = [] {
    if constexpr (W == 1) __syncwarp(); else __syncthreads();
  };
  const int n = S * k;
  float* sd =
      reinterpret_cast<float*>(smem_raw) + threadIdx.x / G * (4 * n + S);
  int* si = reinterpret_cast<int*>(sd + n);
  float* dd = reinterpret_cast<float*>(si + n);
  int* di = reinterpret_cast<int*>(dd + n);
  int* len = di + n;  // valid entries of each list

  if (active) {
    const long long off = static_cast<long long>(b) * n;
#pragma unroll 4
    for (int u = t; u < n; u += G) {
      sd[u] = part_d[off + u];
      si[u] = part_i[off + u];
    }
  }
  sync();
  if (active) {
    for (int s = t; s < S; s += G) {  // the first id < 0 ends a list
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (si[s * k + mid] >= 0) lo = mid + 1; else hi = mid;
      }
      len[s] = lo;
    }
  }
  sync();

  for (int w = 1; w < S; w <<= 1) {
    const int pairs = (S + 2 * w - 1) / (2 * w);
    if (active) {
      for (int u = t; u < pairs * k; u += G) {
        const int p = u / k, o = u % k;
        const int a = 2 * p * w, c = a + w;
        const int la = len[a], lb = c < S ? len[c] : 0;
        const float* ad = sd + a * k;
        const int* ai = si + a * k;
        const float* bd = c < S ? sd + c * k : ad;
        const int* bi = c < S ? si + c * k : ai;
        float vd = INFINITY;
        int vi = repro::kInvalid;
        if (o < la + lb) merge_path_at(ad, ai, la, bd, bi, lb, o, vd, vi);
        dd[a * k + o] = vd;
        di[a * k + o] = vi;
      }
    }
    sync();
    if (active) {
      for (int p = t; p < pairs; p += G) {
        const int a = 2 * p * w, c = a + w;
        len[a] = min(k, len[a] + (c < S ? len[c] : 0));
      }
    }
    float* tf = sd; sd = dd; dd = tf;
    int* ti = si; si = di; di = ti;
    sync();
  }
  if (active) {
    for (int u = t; u < k; u += G) {
      out_d[static_cast<long long>(b) * k + u] = sd[u];
      out_i[static_cast<long long>(b) * k + u] = si[u];
    }
  }
}

// Raise a kernel's dynamic shared memory limit once per process (it is
// not a stream operation, so it also runs before a graph capture).
template <class K>
int allow_smem(K kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

template <class C>
int launch_scan(const float* queries, const float* base, int B, long long N,
                int m, int k, int squared, int vec4, int n_splits,
                long long split_tiles, float* out_d, int* out_i,
                cudaStream_t stream) {
  static bool attr = false;
  const int rc = allow_smem(l2_topk_scan_kernel<C>, &attr);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>((B + C::TQ - 1) / C::TQ),
                  static_cast<unsigned>(n_splits));
  l2_topk_scan_kernel<C><<<grid, kThreads, C::smem_bytes(k), stream>>>(
      queries, base, B, N, m, k, squared, vec4, split_tiles, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int Q>
int launch_merge(const void* part_d, const void* part_i, int B, int S, int k,
                 void* out_d, void* out_i, cudaStream_t stream) {
  static bool attr = false;
  const int rc = allow_smem(l2_topk_merge_kernel<W, Q>, &attr);
  if (rc != 0) return rc;
  const size_t smem =
      sizeof(float) * Q * (4 * static_cast<size_t>(S) * k + S);
  l2_topk_merge_kernel<W, Q><<<(B + Q - 1) / Q, W * Q * 32, smem, stream>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      S, k, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries (B, m) and base (N, m) float32, contiguous; out_d (B, k) float32,
// out_i (B, k) int32; 1 <= k <= min(N, kMaxK); N < 2^31.  tq picks the
// block shape (128: Wide, k <= 32; 32: Mid, k <= 256; 8: Narrow); the
// base's tiles (of TN rows) are cut into n_splits ranges of split_tiles
// tiles, none empty.  With n_splits > 1, part_d / part_i are a (B, n_splits, k)
// workspace and a merge kernel follows the scan on the same stream.
REPRO_EXPORT int l2_topk_f32(const void* queries, const void* base, int B,
                             long long N, int m, int k, int squared, int tq,
                             int n_splits, long long split_tiles,
                             void* part_d, void* part_i, void* out_d,
                             void* out_i, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (k > kMaxK || k > N || N > 0x7fffffffLL || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!((tq == Wide::TQ && k <= kMaxKWide) ||
        (tq == Mid::TQ && k <= kMaxKMid) || tq == Narrow::TQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tn = tq == Wide::TQ ? Wide::TN
                 : tq == Mid::TQ ? Mid::TN : Narrow::TN;
  const long long n_tiles = (N + tn - 1) / tn;
  if (n_splits < 1 || n_splits > kMaxSplits || split_tiles < 1 ||
      (n_splits - 1) * split_tiles >= n_tiles ||
      n_splits * split_tiles < n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_splits > 1 &&
      (n_splits * k > kMergeEntries || part_d == nullptr || part_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(queries);
  const auto* x = static_cast<const float*>(base);
  const int vec4 = m % 4 == 0 && (reinterpret_cast<uintptr_t>(queries) |
                                  reinterpret_cast<uintptr_t>(base)) % 16 == 0;
  float* sd = static_cast<float*>(n_splits > 1 ? part_d : out_d);
  int* si = static_cast<int*>(n_splits > 1 ? part_i : out_i);
  const int rc =
      tq == Wide::TQ
          ? launch_scan<Wide>(q, x, B, N, m, k, squared, vec4, n_splits,
                              split_tiles, sd, si, s)
      : tq == Mid::TQ
          ? launch_scan<Mid>(q, x, B, N, m, k, squared, vec4, n_splits,
                             split_tiles, sd, si, s)
          : launch_scan<Narrow>(q, x, B, N, m, k, squared, vec4, n_splits,
                                split_tiles, sd, si, s);
  if (rc != 0 || n_splits == 1) return rc;
  if (B <= kMergeWideMaxB)
    return launch_merge<8, 1>(part_d, part_i, B, n_splits, k, out_d, out_i,
                              s);
  return launch_merge<1, 2>(part_d, part_i, B, n_splits, k, out_d, out_i, s);
}
