// bag_lookup_bwd: the gradient of bag_lookup's weighted gather-sum
//   out[b, :] = sum_f w[b, f] * table[clip(ids[b, f], 0, V-1), :]
// (w = 0 where ids < 0, w = 1 where no weights are given), given
// g = dL/dout (B, E) float32:
//   grad_w[b, f]  = valid[b, f] * dot(table[clip(ids[b, f])], g[b])
//   grad_table[r] = sum over (b, f) with valid id clip(ids[b, f]) == r
//                   of w[b, f] * g[b]                      (dense, V x E)
// An invalid id's row is never read and adds nothing.
//
// Replaces no TPU kernel: JAX differentiates DIN's pooling sum
// (src/repro/models/recsys.py:220, interest = sum(w * hist, axis=1)) with
// its own autodiff, while the port computes that sum with the hand-written
// bag_lookup (csrc/bag_lookup.cu, which replaces bag_lookup_pallas), so the
// kernel needs a gradient of its own.  Contract: kernels/bag_lookup/ref.py.
//
// Bound on the H100: bytes (ids, weights and g read, the distinct rows
// read for grad_w, grad_w and the whole grad_table written), at 4 E flops
// an entry.  Design, deterministic: no float atomics.
// * grad_w: one warp per bag, as the forward; a lane takes a field and
//   sums its row against g[b] over E in order.
// * grad_table: the wrapper sorts the B*F entries by row (a stable
//   torch.sort of the keys clip(id), V for an invalid id: index
//   preparation only).  Then (1) row_start[r], the first sorted position
//   of row r, by a binary search a row (row_start[V] counts the valid
//   entries); (2) the valid sorted entries are cut into chunks of `chunk`
//   positions, one warp each, lanes over E: the warp walks its chunk in
//   order, a row's entries summed in position order; a row wholly inside
//   the chunk is written straight to grad_table, a row that crosses a
//   chunk edge leaves a partial sum (slot 0 for the chunk's first
//   segment, when it starts at the chunk's start, slot 1 for its last);
//   (3) one warp a row writes every other row once: zeros for a row no id
//   names, else the partials of its chunks added in chunk order.  The
//   Zipf head (DIN's history puts about a quarter of its entries on one
//   row) is spread over many chunks instead of serialising one warp or
//   piling atomics on one address, and every sum has a fixed order, so
//   two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// row_start[r] = the first sorted position whose key is >= r, r in [0, V].
__global__ void bag_bwd_row_start(const int* __restrict__ keys, long long n,
                                  long long V, int* __restrict__ row_start) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r > V) return;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  row_start[r] = static_cast<int>(lo);
}

// The sum of one row's segment [seg, ...) of chunk c = [lo, hi): straight
// into grad_table if the row lies wholly inside the chunk, else a partial.
__device__ __forceinline__ void flush(int row, long long seg, long long lo,
                                      long long hi, long long c,
                                      const int* __restrict__ row_start,
                                      int E, int e, float acc,
                                      float* __restrict__ partial,
                                      float* __restrict__ grad_table) {
  const long long rs = row_start[row];
  const long long re = row_start[row + 1];
  if (rs >= lo && re <= hi) {
    grad_table[static_cast<long long>(row) * E + e] = acc;
  } else {
    partial[(c * 2 + (seg == lo ? 0 : 1)) * E + e] = acc;
  }
}

__global__ void bag_bwd_chunk(const float* __restrict__ g, int E,
                              const float* __restrict__ weights, int F,
                              const int* __restrict__ keys,
                              const long long* __restrict__ perm,
                              const int* __restrict__ row_start, long long V,
                              long long n_chunks, int chunk,
                              float* __restrict__ partial,
                              float* __restrict__ grad_table) {
  const long long c =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;  // whole warp leaves together
  const long long n_valid = row_start[V];
  const long long lo = c * chunk;
  if (lo >= n_valid) return;
  const long long hi = min(lo + chunk, n_valid);
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const bool active = e < E;
    float acc = 0.f;
    int row = __ldg(keys + lo);
    long long seg = lo;
    for (long long j0 = lo; j0 < hi; j0 += 32) {
      // lane t holds entry j0 + t: its row, its bag and its weight
      int my_key = repro::kInvalid, my_b = 0;
      float my_w = 0.f;
      if (j0 + lane < hi) {
        my_key = __ldg(keys + j0 + lane);
        const long long p = __ldg(perm + j0 + lane);
        my_b = static_cast<int>(p / F);
        my_w = weights == nullptr ? 1.f : __ldg(weights + p);
      }
      const int n = static_cast<int>(min(32LL, hi - j0));
      float gv[32];  // the 32 entries' g values, loaded before the sums
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int b = __shfl_sync(repro::kFullMask, my_b, t);
        gv[t] = (t < n && active)
                    ? __ldg(g + static_cast<long long>(b) * E + e)
                    : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int key = __shfl_sync(repro::kFullMask, my_key, t);
        const float w = __shfl_sync(repro::kFullMask, my_w, t);
        if (t < n) {  // warp-uniform
          if (key != row) {
            if (active) {
              flush(row, seg, lo, hi, c, row_start, E, e, acc, partial,
                    grad_table);
            }
            row = key;
            seg = j0 + t;
            acc = 0.f;
          }
          acc = fmaf(w, gv[t], acc);
        }
      }
    }
    if (active) {
      flush(row, seg, lo, hi, c, row_start, E, e, acc, partial, grad_table);
    }
  }
}

// Every row the chunk pass did not write: zeros, or its chunks' partials
// in chunk order (the first chunk's slot 1 unless the row starts at that
// chunk's start, then slot 0 of each later chunk).
__global__ void bag_bwd_rows(const int* __restrict__ row_start, long long V,
                             int E, int chunk,
                             const float* __restrict__ partial,
                             float* __restrict__ grad_table) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= V) return;
  const long long rs = row_start[r];
  const long long re = row_start[r + 1];
  const long long c0 = rs / chunk;
  const long long c1 = (re - 1) / chunk;
  if (rs < re && c0 == c1) return;  // written by the chunk pass
  for (int e = lane; e < E; e += 32) {
    float acc = 0.f;
    if (rs < re) {
      acc = partial[(c0 * 2 + (rs == c0 * chunk ? 0 : 1)) * E + e];
      long long c = c0 + 1;
      for (; c + 8 <= c1 + 1; c += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = partial[(c + k) * 2 * E + e];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += v[k];
      }
      for (; c <= c1; ++c) acc += partial[c * 2 * E + e];
    }
    grad_table[r * E + e] = acc;
  }
}

// One warp a bag, one lane a field: grad_w[b, f] = dot(row, g[b]) over E
// in order, 0 for an invalid id.
__global__ void bag_bwd_grad_w(const float* __restrict__ table, long long V,
                               int E, const int* __restrict__ ids,
                               const float* __restrict__ g,
                               float* __restrict__ grad_w, long long B,
                               int F) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const float* gb = g + b * E;
  for (int f = lane; f < F; f += 32) {
    const int id = __ldg(ids + b * F + f);
    float s = 0.f;
    if (id >= 0) {
      const long long row = id >= V ? V - 1 : id;
      const float* tr = table + row * E;
      for (int e = 0; e < E; ++e) s = fmaf(__ldg(tr + e), __ldg(gb + e), s);
    }
    grad_w[b * F + f] = s;
  }
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// keys (B*F,) int32: the sorted keys clip(id) (V for an invalid id), perm
// (B*F,) int64 the entries' positions b*F + f in that order; row_start
// (V+1,) int32 and partial (2 * ceil(B*F / chunk) * E,) float32 are
// scratch.  grad_w or grad_table may be null (not wanted); keys, perm,
// row_start and partial are read only for grad_table.  The wrapper
// launches nothing for B, F or E of 0.
REPRO_EXPORT int bag_lookup_bwd_f32(const void* table, long long V, int E,
                                    const void* ids, const void* weights,
                                    const void* g, long long B, int F,
                                    const void* keys, const void* perm,
                                    void* row_start, void* partial, int chunk,
                                    void* grad_w, void* grad_table,
                                    void* stream) {
  if (B == 0 || E == 0 || F == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  if (grad_table != nullptr) {
    const long long n = B * F;
    const long long n_chunks = (n + chunk - 1) / chunk;
    auto* rs = static_cast<int*>(row_start);
    bag_bwd_row_start<<<blocks_for(V + 1), kThreads, 0, s>>>(
        static_cast<const int*>(keys), n, V, rs);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    bag_bwd_chunk<<<blocks_for(n_chunks * 32), kThreads, 0, s>>>(
        gf, E, static_cast<const float*>(weights), F,
        static_cast<const int*>(keys), static_cast<const long long*>(perm),
        rs, V, n_chunks, chunk, static_cast<float*>(partial),
        static_cast<float*>(grad_table));
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    bag_bwd_rows<<<blocks_for(V * 32), kThreads, 0, s>>>(
        rs, V, E, chunk, static_cast<const float*>(partial),
        static_cast<float*>(grad_table));
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (grad_w != nullptr) {
    bag_bwd_grad_w<<<blocks_for(B * 32), kThreads, 0, s>>>(
        static_cast<const float*>(table), V, E, static_cast<const int*>(ids),
        gf, static_cast<float*>(grad_w), B, F);
  }
  return static_cast<int>(cudaGetLastError());
}
