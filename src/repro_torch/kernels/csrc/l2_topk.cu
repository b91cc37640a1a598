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
// Bound on the H100: operations.  2 B N m flops of float32 dot products
// against (B + N) m floats read once; at the ground truth's B=10,000,
// N=53,387, m=192 that is 2.05e11 flops (3.06 ms at 67 TFLOP/s) against
// 49 MB (0.015 ms at 3.35 TB/s).  The reference is full float32, so the
// products are plain FP32 FMAs: no tensor cores, no TF32.
//
// Design.  The TPU's sequential N axis becomes a loop over base tiles
// inside one block; blocks are independent and own TQ queries each.  Per
// tile of TN=128 rows, the block computes the (TQ, TN) dot products in
// chunks of KC=32 dimensions staged in shared memory (queries and rows
// transposed, padded by one float against bank conflicts); each thread
// holds a (TQ/8, 4) register tile, reading its queries as warp broadcasts
// and its rows as consecutive words.  Row norms are summed from the same
// staged chunks.  The (TQ, TN) distance tile goes to shared memory, never
// to device memory.  Then one warp per query merges the tile into the
// query's running top-k, a list sorted by (distance, id) in shared memory:
// a ballot picks the tile entries that beat the list's last entry, and
// each is inserted in id order (a warp-wide count gives its position, the
// tail shifts by one).  After the first tiles few entries beat the list,
// so the merge costs little beside the products.  The ragged edges are
// masked: rows >= N never enter a list, dims >= m load as 0, and no
// padding is written anywhere.  TQ is 32 when there are enough queries to
// fill the card with blocks of 32 (and k <= kMaxK32), else 8.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 128;               // base rows per tile
constexpr int kKC = 32;                // dims per staged chunk
constexpr int kRowsPerThread = kTN / 32;
constexpr int kMaxK = 2048;            // kernels/l2_topk/ops.py MAX_K
constexpr int kMaxK32 = 256;           // largest k of the TQ=32 variant

// (d, i) < (e, j) in the (distance, id) order
__device__ __forceinline__ bool key_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

template <int TQ>
struct Smem {
  static constexpr int kQPT = TQ / kWarps;            // queries per thread
  static size_t bytes(int k) {
    return sizeof(float) * (static_cast<size_t>(kKC) * (TQ + 1)   // qs
                            + static_cast<size_t>(kKC) * (kTN + 1)  // xs
                            + static_cast<size_t>(kWarps) * kTN     // xpart
                            + static_cast<size_t>(TQ) * kTN         // tile
                            + TQ)                                   // qn
           + static_cast<size_t>(TQ) * k * (sizeof(float) + sizeof(int))
           + sizeof(int) * TQ;                                      // counts
  }
};

// Insert (d, id) into the sorted list (ld, li) of cnt <= k entries; one
// warp, every lane returns the new count.
__device__ __forceinline__ int warp_insert(float* ld, int* li, int cnt,
                                           int k, float d, int id,
                                           int lane) {
  int below = 0;
  for (int t = lane; t < cnt; t += 32) below += key_less(ld[t], li[t], d, id);
  for (int o = 16; o > 0; o >>= 1)
    below += __shfl_xor_sync(repro::kFullMask, below, o);
  const int pos = below;
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

template <int TQ>
__global__ void __launch_bounds__(kThreads)
l2_topk_kernel(const float* __restrict__ queries,
               const float* __restrict__ base, int B, long long N, int m,
               int k, int squared, float* __restrict__ out_d,
               int* __restrict__ out_i) {
  constexpr int QPT = Smem<TQ>::kQPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);        // [kKC][TQ + 1]
  float* xs = qs + kKC * (TQ + 1);                       // [kKC][kTN + 1]
  float* xpart = xs + kKC * (kTN + 1);                   // [kWarps][kTN]
  float* tile = xpart + kWarps * kTN;                    // [TQ][kTN]
  float* qn = tile + TQ * kTN;                           // [TQ]
  float* list_d = qn + TQ;                               // [TQ][k]
  int* list_i = reinterpret_cast<int*>(list_d + TQ * k); // [TQ][k]
  int* counts = list_i + TQ * k;                         // [TQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;

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
    }
  }

  for (long long r0 = 0; r0 < N; r0 += kTN) {
    float acc[QPT][kRowsPerThread];
    float xn_part[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) xn_part[j] = 0.f;

    for (int c0 = 0; c0 < m; c0 += kKC) {
      __syncthreads();  // the previous chunk's (or tile's merge) reads done
      const int c = c0 + lane;
      // stage the chunk: warp w reads row (w + 8 s), 32 consecutive dims
      for (int r = warp; r < kTN; r += kWarps) {
        const long long g = r0 + r;
        xs[lane * (kTN + 1) + r] =
            (g < N && c < m) ? __ldg(base + g * m + c) : 0.f;
      }
      for (int q = warp; q < TQ; q += kWarps) {
        qs[lane * (TQ + 1) + q] =
            (q0 + q < B && c < m)
                ? __ldg(queries + static_cast<long long>(q0 + q) * m + c)
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        float a[QPT], b[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          a[i] = qs[kk * (TQ + 1) + warp + kWarps * i];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
          b[j] = xs[kk * (kTN + 1) + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // this warp's share of the row norms: dims kk = warp (mod 8)
      for (int kk = warp; kk < kKC; kk += kWarps)
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const float x = xs[kk * (kTN + 1) + lane + 32 * j];
          xn_part[j] = fmaf(x, x, xn_part[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      xpart[warp * kTN + lane + 32 * j] = xn_part[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = lane + 32 * j;
      float xn = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) xn += xpart[w * kTN + r];
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int q = warp + kWarps * i;
        // (|q|^2 - 2 q.x) + |x|^2, each step rounded on its own
        float d2 = __fadd_rn(__fsub_rn(qn[q], __fmul_rn(2.f, acc[i][j])), xn);
        d2 = fmaxf(d2, 0.f);
        tile[q * kTN + r] = squared ? d2 : sqrtf(d2);
      }
    }
    __syncthreads();

    // merge: warp w owns queries w, w + 8, ...
    for (int q = warp; q < TQ; q += kWarps) {
      if (q0 + q >= B) continue;  // warp-uniform
      float* ld = list_d + q * k;
      int* li = list_i + q * k;
      int cnt = counts[q];
#pragma unroll 1
      for (int j = 0; j < kRowsPerThread; ++j) {
        const long long g = r0 + lane + 32 * j;
        const float d = tile[q * kTN + lane + 32 * j];
        const int id = static_cast<int>(g);
        const bool valid = g < N && !isnan(d);
        const bool full = cnt == k;
        const float last_d = full ? ld[k - 1] : 0.f;
        const int last_i = full ? li[k - 1] : 0;
        unsigned want = __ballot_sync(
            repro::kFullMask,
            valid && (!full || key_less(d, id, last_d, last_i)));
        while (want) {
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float cd = __shfl_sync(repro::kFullMask, d, src);
          const int ci = __shfl_sync(repro::kFullMask, id, src);
          // the list may have moved since the ballot
          if (cnt == k && !key_less(cd, ci, ld[k - 1], li[k - 1])) continue;
          cnt = warp_insert(ld, li, cnt, k, cd, ci, lane);
        }
      }
      if (lane == 0) counts[q] = cnt;
      __syncwarp();
    }
  }
  __syncthreads();

  for (int q = warp; q < TQ; q += kWarps) {
    const int b = q0 + q;
    if (b >= B) continue;
    const int cnt = counts[q];
    for (int t = lane; t < k; t += 32) {
      const bool have = t < cnt;
      out_d[static_cast<long long>(b) * k + t] =
          have ? list_d[q * k + t] : INFINITY;
      out_i[static_cast<long long>(b) * k + t] =
          have ? list_i[q * k + t] : repro::kInvalid;
    }
  }
}

template <int TQ>
int launch(const void* queries, const void* base, int B, long long N, int m,
           int k, int squared, void* out_d, void* out_i, void* stream) {
  const size_t smem = Smem<TQ>::bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        l2_topk_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((B + TQ - 1) / TQ);
  l2_topk_kernel<TQ><<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(base), B,
      N, m, k, squared, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries (B, m) and base (N, m) float32, contiguous; out_d (B, k) float32,
// out_i (B, k) int32.  1 <= k <= min(N, kMaxK); N < 2^31.
REPRO_EXPORT int l2_topk_f32(const void* queries, const void* base, int B,
                             long long N, int m, int k, int squared,
                             void* out_d, void* out_i, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (k > kMaxK || k > N || N > 0x7fffffffLL || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // blocks of 32 queries once they alone fill every SM, else blocks of 8
  if (k <= kMaxK32 && (B + 31) / 32 >= sms)
    return launch<32>(queries, base, B, N, m, k, squared, out_d, out_i,
                      stream);
  return launch<8>(queries, base, B, N, m, k, squared, out_d, out_i, stream);
}
