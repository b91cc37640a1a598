// bag_bwd_order: the first pass of an embedding bag's backward over its
// entries (b, f), e = b * F + f, of the bag
//   out[b, :] = sum_f w[b, f] * table[clip(ids[b, f], 0, V-1), :]
// (w = 0 where ids < 0, w = 1 where no weights are given), given
// g = dL/dout (B, E) float32:
//   grad_w[e]  = valid[e] * dot(table[clip(ids[e])], g[b])      (optional)
//   the valid entries sorted by key clip(ids[e], 0, V-1), stably: keys,
//   positions e and, where weights are given, w[e] in that order, and
//   their count.  An invalid entry is never sorted.
// The order is the index preparation of bag_lookup_bwd.cu, which takes the
// table's gradient from it; DIN's history shares one order between its
// gather and its bag a step (models/embedding_bag.py::HistoryRows).
//
// Replaces no TPU kernel: with bag_lookup_bwd.cu it takes the role of
// JAX's autodiff of DIN's history lookup and pooling sum
// (src/repro/models/recsys.py:212-220).  Contract: kernels/bag_lookup/
// ref.py::bwd_order_ref.
//
// Bound on the H100: bytes (ids read, the valid entries' weights read and
// their keys, positions and weights written; for grad_w the distinct rows
// and g read and grad_w written).  Design, deterministic: grad_w first
// (order_grad_w: a warp a bag, a lane an entry's dot product in column
// order), then a stable LSD counting sort over the keys' bits, kBits a
// pass (DIN's V = 256,205 has 18 bits: two passes), each pass
// three launches:
// * count: one block a tile of kTile entries writes the tile's digit
//   histogram (shared-memory integer atomics: a count has no order);
// * scan: one block a digit, the exclusive scan of its counts over the
//   tiles, and the digit's total;
// * scatter: each tile ranks its entries stably within the tile: warp w
//   takes the w-th run of 256 entries in rounds of 32, and __match_any_sync
//   on the digit gives each lane its rank among the round's equal digits,
//   added to the warp's running count of that digit; the warps' counts
//   are then scanned across warps and digits.  The tile is sorted by digit
//   in shared memory, then written out run by run, so neighbouring
//   threads write neighbouring addresses.
// Pass 0 reads the ids and drops the invalid entries; later passes read
// the previous pass's output, as many entries as pass 0 counted.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // entries a thread
constexpr int kRun = kItems * 32;            // entries a warp
constexpr int kTile = kThreads * kItems;     // entries a block
constexpr int kBits = 9;
constexpr int kBins = 1 << kBits;
constexpr int kNone = kBins;                 // the digit of no entry

// Exclusive scan of one int a thread over the block, in thread order;
// *total gets the sum.  wsum holds kWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(repro::kFullMask, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                  // wsum may still be read by a caller
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? wsum[w] : 0;
    all += wsum[w];
  }
  *total = all;
  return before + x - v;
}

// The sort key of entry i: clip(id, V - 1), or -1 for an invalid id (pass
// 0), or the previous pass's key.
template <bool kFirst>
__device__ __forceinline__ int entry_key(const int* __restrict__ src,
                                         long long i, long long V) {
  const int k = __ldg(src + i);
  if (!kFirst) return k;
  return k < 0 ? -1 : (k >= V ? static_cast<int>(V - 1) : k);
}

__device__ __forceinline__ int digit_of(int key, int shift) {
  return key < 0 ? kNone : (key >> shift) & (kBins - 1);
}

// grad_w: one warp a bag, one lane a field (as bag_lookup's forward): the
// entry's row against g[b] over E in column order by fmaf, from 0; the
// rows come from L2 (DIN's distinct rows are 4.2 MB).  An invalid
// entry's row is never read; its grad_w is 0.
__global__ void __launch_bounds__(kThreads)
order_grad_w(const int* __restrict__ ids, long long B, int F, long long V,
             const float* __restrict__ table, int E,
             const float* __restrict__ g, float* __restrict__ grad_w) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const float* gb = g + b * E;
  for (int f = lane; f < F; f += 32) {
    const int k = entry_key<true>(ids, b * F + f, V);
    float s = 0.f;
    if (k >= 0) {
      const float* row = table + static_cast<long long>(k) * E;
      for (int c = 0; c < E; ++c) s = fmaf(__ldg(row + c), __ldg(gb + c), s);
    }
    grad_w[b * F + f] = s;
  }
}

// counts[d * n_tiles + tile]: the tile's entries of digit d.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
order_count(const int* __restrict__ src, long long n_all,
            const int* __restrict__ count, long long V, int shift,
            int n_tiles, int* __restrict__ counts) {
  __shared__ int hist[kBins];
  for (int d = threadIdx.x; d < kBins; d += kThreads) hist[d] = 0;
  __syncthreads();
  const long long n = kFirst ? n_all : *count;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (base < n) {
#pragma unroll 4
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < n) {
        const int d = digit_of(entry_key<kFirst>(src, i, V), shift);
        if (d != kNone) atomicAdd(&hist[d], 1);
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += kThreads)
    counts[static_cast<long long>(d) * n_tiles + blockIdx.x] = hist[d];
}

// One block a digit: its counts over the tiles, exclusive-scanned in
// place; totals[d] their sum.
__global__ void __launch_bounds__(kThreads)
order_scan(int* __restrict__ counts, int n_tiles, int* __restrict__ totals) {
  __shared__ int wsum[kWarps];
  int* c = counts + static_cast<long long>(blockIdx.x) * n_tiles;
  int carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads * 4) {
    int v[4], s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + threadIdx.x * 4 + k;
      v[k] = t < n_tiles ? c[t] : 0;
      s += v[k];
    }
    int total;
    int before = carry + block_exclusive_scan(s, wsum, &total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + threadIdx.x * 4 + k;
      if (t < n_tiles) c[t] = before;
      before += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The stable scatter of one pass: the tile's valid entries to their sorted
// places.  Pass 0 writes the count of valid entries (block 0).
template <bool kFirst>
__global__ void __launch_bounds__(kThreads, 4)
order_scatter(const int* __restrict__ src, const int* __restrict__ pos_in,
              const float* __restrict__ w_in, long long n_all,
              int* __restrict__ count, long long V, int shift, int n_tiles,
              const int* __restrict__ counts, const int* __restrict__ totals,
              int* __restrict__ keys_out, int* __restrict__ pos_out,
              float* __restrict__ w_out) {
  __shared__ unsigned short whist[kWarps][kBins];
  __shared__ int blk_off[kBins];
  __shared__ int glob_off[kBins];
  __shared__ int stage_k[kTile];
  __shared__ int stage_p[kTile];
  __shared__ int wsum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = kFirst ? n_all : *count;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  // where each digit's entries of this tile start in the output: the
  // digits' totals scanned, plus the earlier tiles' counts
  int all;
  const int tot0 = totals[2 * threadIdx.x], tot1 = totals[2 * threadIdx.x + 1];
  const int t_before = block_exclusive_scan(tot0 + tot1, wsum, &all);
  glob_off[2 * threadIdx.x] =
      t_before + counts[static_cast<long long>(2 * threadIdx.x) * n_tiles +
                        blockIdx.x];
  glob_off[2 * threadIdx.x + 1] =
      t_before + tot0 +
      counts[static_cast<long long>(2 * threadIdx.x + 1) * n_tiles +
             blockIdx.x];
  if (kFirst && blockIdx.x == 0 && threadIdx.x == 0) *count = all;
  if (base >= n) return;                     // block-uniform
  for (int d = lane; d < kBins; d += 32) whist[warp][d] = 0;
  __syncwarp();

  // load: lane takes entry base + warp * kRun + r * 32 + lane of round r
  int key[kItems], rank[kItems];
  const long long wbase = base + static_cast<long long>(warp) * kRun;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = wbase + r * 32 + lane;
    key[r] = i < n ? entry_key<kFirst>(src, i, V) : -1;
  }
  // rank: each lane's place among the warp's earlier entries of its digit
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int d = digit_of(key[r], shift);
    const unsigned peers = __match_any_sync(repro::kFullMask, d);
    const int before = d == kNone ? 0 : whist[warp][d];
    __syncwarp();
    if (d != kNone && lane == __ffs(peers) - 1)
      whist[warp][d] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
    rank[r] = before + __popc(peers & lt);
  }
  __syncthreads();
  // per digit: the warps' counts to exclusive offsets across warps; then
  // the tile's digit totals scanned across digits
  int dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 2 * threadIdx.x + h;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = whist[w][d];
      whist[w][d] = static_cast<unsigned short>(s);
      s += c;
    }
    dsum[h] = s;
  }
  int n_tile;
  const int b_before = block_exclusive_scan(dsum[0] + dsum[1], wsum, &n_tile);
  blk_off[2 * threadIdx.x] = b_before;
  blk_off[2 * threadIdx.x + 1] = b_before + dsum[0];
  __syncthreads();
  // the tile sorted by digit in shared memory
  int* local = rank;                  // each entry's place in the tile
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int d = digit_of(key[r], shift);
    local[r] = d == kNone ? -1 : blk_off[d] + whist[warp][d] + rank[r];
    if (local[r] >= 0) {
      const long long i = wbase + r * 32 + lane;
      stage_k[local[r]] = key[r];
      stage_p[local[r]] =
          kFirst ? static_cast<int>(i) : __ldg(pos_in + i);
    }
  }
  __syncthreads();
  // out run by run: the j-th of the tile's sorted entries goes to its
  // digit's place plus its place within the digit's run
  for (int j = threadIdx.x; j < n_tile; j += kThreads) {
    const int k = stage_k[j];
    const int d = (k >> shift) & (kBins - 1);
    const long long dst = static_cast<long long>(glob_off[d]) + j - blk_off[d];
    keys_out[dst] = k;
    pos_out[dst] = stage_p[j];
  }
  if (w_out == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (local[r] >= 0) {
      const long long i = wbase + r * 32 + lane;
      stage_p[local[r]] = __float_as_int(__ldg(w_in + i));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_tile; j += kThreads) {
    const int d = (stage_k[j] >> shift) & (kBins - 1);
    const long long dst = static_cast<long long>(glob_off[d]) + j - blk_off[d];
    w_out[dst] = __int_as_float(stage_p[j]);
  }
}

}  // namespace

// n = B * F entries, ids in [-1, V) after the clip, passes = ceil(the
// bits of V - 1 / kBits) (at least 1).  ids (n,) int32; weights (n,)
// float32 or null (then no w is sorted); keys, pos (2, n) int32 and w
// (2, n) float32 or null: pass p writes row p % 2, so the result is row
// (passes - 1) % 2; count (1,) int32: the valid entries; counts
// (kBins * n_tiles,) and totals (kBins,) int32 scratch.  grad_w (n,)
// float32 or null (not wanted; then table and g are unused), with table
// (V, E), g (n / F, E) float32.  keys null: grad_w only.  The wrapper
// launches nothing for n = 0.
REPRO_EXPORT int bag_bwd_order_f32(const void* ids, long long n, long long V,
                                   int passes, const void* weights,
                                   const void* table, int E, const void* g,
                                   int F, void* grad_w,
                                   void* keys, void* pos, void* w, void* count,
                                   void* counts, void* totals, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const auto* id = static_cast<const int*>(ids);
  const auto* tf = static_cast<const float*>(table);
  const auto* gf = static_cast<const float*>(g);
  auto* gw = static_cast<float*>(grad_w);
  auto* cnt = static_cast<int*>(count);
  auto* cs = static_cast<int*>(counts);
  auto* tot = static_cast<int*>(totals);
  if (gw != nullptr && E > 0) {
    const long long B = n / F;
    order_grad_w<<<static_cast<unsigned>((B * 32 + kThreads - 1) / kThreads),
                   kThreads, 0, s>>>(id, B, F, V, tf, E, gf, gw);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  } else if (gw != nullptr) {
    const int rc = static_cast<int>(
        cudaMemsetAsync(gw, 0, static_cast<size_t>(n) * sizeof(float), s));
    if (rc != 0) return rc;
  }
  if (keys == nullptr) return 0;
  auto* k = static_cast<int*>(keys);
  auto* p = static_cast<int*>(pos);
  auto* wf = static_cast<float*>(w);
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kBits;
    const long long out = (pass % 2) * n, in = ((pass + 1) % 2) * n;
    float* w_out = weights == nullptr ? nullptr : wf + out;
    if (pass == 0) {
      order_count<true><<<n_tiles, kThreads, 0, s>>>(id, n, cnt, V, shift,
                                                      n_tiles, cs);
    } else {
      order_count<false><<<n_tiles, kThreads, 0, s>>>(k + in, n, cnt, V,
                                                       shift, n_tiles, cs);
    }
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    order_scan<<<kBins, kThreads, 0, s>>>(cs, n_tiles, tot);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    if (pass == 0) {
      order_scatter<true><<<n_tiles, kThreads, 0, s>>>(
          id, nullptr, static_cast<const float*>(weights), n, cnt, V, shift,
          n_tiles, cs, tot, k + out, p + out, w_out);
    } else {
      order_scatter<false><<<n_tiles, kThreads, 0, s>>>(
          k + in, p + in, weights == nullptr ? nullptr : wf + in, n, cnt, V,
          shift, n_tiles, cs, tot, k + out, p + out, w_out);
    }
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}
