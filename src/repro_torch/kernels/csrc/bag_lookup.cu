// bag_lookup: out[b, :] = sum_f w[b, f] * table[clip(ids[b, f], 0, V-1), :]
// over float32 rows, with w[b, f] = 0 where ids[b, f] < 0 and w = 1 where
// no weights are given.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bag_lookup/
// bag_lookup.py::bag_lookup_pallas (grid (B, F) with F innermost, one
// scalar-prefetched row DMA per step, out[b] resident in VMEM: set at
// f == 0, accumulated once per field).  Contract: kernels/bag_lookup/ref.py.
//
// Bound on the H100: bytes.  Each field moves one row of E floats from a
// random address for 2E flops.  Design: one warp per bag; the TPU's
// sequential F axis becomes a loop inside the warp, and out[b] lives in
// float32 registers, written once.  Lanes span E (16-byte loads of 4
// floats where E % 4 == 0 and the table is 16-byte aligned: E = 16 and 128
// take them, E = 18's 72-byte rows do not; otherwise one float a lane; a
// strided loop when a row has more than 32 units).  The bag's ids and
// weights are read once, 32 fields at a time, one a lane, and broadcast
// with __shfl_sync.  An invalid id (< 0) has weight 0 and its row is never
// read.  Row offsets are 64-bit (row x E passes 2^31 on DLRM's table).
// Nothing is padded: the TPU wrapper's 128-lane padding and the output
// slice are gone.
//
// Where a row's units are a power of two below 32 (E = 16 in float4: 4
// units; the reduced configs' E = 8: 2), one row would leave most lanes
// idle and the fields would be read one after another.  There the warp is
// split into G = 32 / units lane groups: group g takes fields f = g (mod
// G), in order, into its own float32 accumulators, so G rows are in flight
// at once (DCN-v2's F = 26 at E = 16: at most 4 row loads a lane instead
// of 26 in series); then the groups are summed by __shfl_xor_sync over
// lane offsets units, 2 units, ... .  That order is fixed, so the result
// is deterministic; it differs from the in-order sum by rounding only.
// Any other E (DIN's 18, 7, DLRM's 128) keeps the in-order path, fields
// added f = 0..F-1 as the TPU kernel adds them.
#include "common.cuh"

namespace {

template <int VW>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  __device__ static void fma(T& acc, float w, const T* p) {
    acc = fmaf(w, __ldg(p), acc);
  }
  __device__ static void zero(T& acc) { acc = 0.f; }
  __device__ static void add_xor(T& acc, int o) {
    acc += __shfl_xor_sync(repro::kFullMask, acc, o);
  }
};

template <>
struct Vec<4> {
  using T = float4;
  __device__ static void fma(T& acc, float w, const T* p) {
    const float4 x = __ldg(p);
    acc.x = fmaf(w, x.x, acc.x);
    acc.y = fmaf(w, x.y, acc.y);
    acc.z = fmaf(w, x.z, acc.z);
    acc.w = fmaf(w, x.w, acc.w);
  }
  __device__ static void zero(T& acc) { acc = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add_xor(T& acc, int o) {
    acc.x += __shfl_xor_sync(repro::kFullMask, acc.x, o);
    acc.y += __shfl_xor_sync(repro::kFullMask, acc.y, o);
    acc.z += __shfl_xor_sync(repro::kFullMask, acc.z, o);
    acc.w += __shfl_xor_sync(repro::kFullMask, acc.w, o);
  }
};

// VW floats a lane; units = E / VW units a row.
template <int VW>
__global__ void bag_lookup_kernel(const float* __restrict__ table,
                                  long long n_rows, int units,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ weights,
                                  float* __restrict__ out, long long n_bags,
                                  int F) {
  using V = Vec<VW>;
  using T = typename V::T;
  const long long bag =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bag >= n_bags) return;  // whole warp leaves together
  const T* rows = reinterpret_cast<const T*>(table);
  const int* bag_ids = ids + bag * F;
  const float* bag_w = weights == nullptr ? nullptr : weights + bag * F;
  T* bag_out = reinterpret_cast<T*>(out) + bag * units;
  for (int u0 = 0; u0 < units; u0 += 32) {
    const int u = u0 + lane;
    T acc;
    V::zero(acc);
    for (int f0 = 0; f0 < F; f0 += 32) {
      int my_id = repro::kInvalid;
      float my_w = 0.f;
      if (f0 + lane < F) {
        my_id = bag_ids[f0 + lane];
        my_w = bag_w == nullptr ? 1.f : bag_w[f0 + lane];
      }
      const int n = min(32, F - f0);
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(repro::kFullMask, my_id, j);
        const float w = __shfl_sync(repro::kFullMask, my_w, j);
        if (id < 0 || u >= units) continue;  // weight 0: nothing to add
        const long long row = id >= n_rows ? n_rows - 1 : id;
        V::fma(acc, w, rows + row * units + u);
      }
    }
    if (u < units) bag_out[u] = acc;
  }
}

// Lane groups of `units` lanes (a power of two below 32): group g sums
// fields g, g + G, ... of the bag, then the groups are added pairwise.
template <int VW>
__global__ void bag_lookup_grouped_kernel(const float* __restrict__ table,
                                          long long n_rows, int units,
                                          const int* __restrict__ ids,
                                          const float* __restrict__ weights,
                                          float* __restrict__ out,
                                          long long n_bags, int F) {
  using V = Vec<VW>;
  using T = typename V::T;
  const long long bag =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bag >= n_bags) return;  // whole warp leaves together
  const int G = 32 / units;
  const int g = lane / units;
  const int u = lane % units;
  const T* rows = reinterpret_cast<const T*>(table);
  const int* bag_ids = ids + bag * F;
  const float* bag_w = weights == nullptr ? nullptr : weights + bag * F;
  T acc;
  V::zero(acc);
  for (int f0 = 0; f0 < F; f0 += 32) {
    int my_id = repro::kInvalid;
    float my_w = 0.f;
    if (f0 + lane < F) {
      my_id = bag_ids[f0 + lane];
      my_w = bag_w == nullptr ? 1.f : bag_w[f0 + lane];
    }
    // group g's fields of this block of 32 sit in lanes g, g + G, ...
    for (int src = g; src < 32; src += G) {
      const int id = __shfl_sync(repro::kFullMask, my_id, src);
      const float w = __shfl_sync(repro::kFullMask, my_w, src);
      if (id < 0) continue;  // weight 0 (or past F): nothing to add
      const long long row = id >= n_rows ? n_rows - 1 : id;
      V::fma(acc, w, rows + row * units + u);
    }
  }
  for (int o = units; o < 32; o <<= 1) V::add_xor(acc, o);
  if (g == 0) reinterpret_cast<T*>(out)[bag * units + u] = acc;
}

template <int VW>
void launch_vw(const float* table, long long n_rows, int E, const int* ids,
               const float* weights, float* out, long long B, int F,
               cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (B * 32 + threads - 1) / threads;
  const int units = E / VW;
  if (units < 32 && (units & (units - 1)) == 0) {
    bag_lookup_grouped_kernel<VW><<<static_cast<unsigned>(blocks), threads,
                                    0, stream>>>(table, n_rows, units, ids,
                                                 weights, out, B, F);
  } else {
    bag_lookup_kernel<VW><<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(table, n_rows, units, ids, weights, out,
                                      B, F);
  }
}

}  // namespace

// weights may be null (every weight 1).  The wrapper launches nothing for
// an empty bag batch (B, F or E of 0): it returns zeros.
REPRO_EXPORT int bag_lookup_f32(const void* table, long long n_rows, int E,
                                const void* ids, const void* weights,
                                void* out, long long B, int F, void* stream) {
  if (B == 0 || E == 0 || F == 0) return 0;
  const bool vec4 =
      E % 4 == 0 && (reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int*>(ids);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  if (vec4) {
    launch_vw<4>(t, n_rows, E, i, w, o, B, F, s);
  } else {
    launch_vw<1>(t, n_rows, E, i, w, o, B, F, s);
  }
  return static_cast<int>(cudaGetLastError());
}
