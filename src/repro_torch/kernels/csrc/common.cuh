// Shared by every kernel library of the port (see kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kInvalid = -1;   // core/graph.py INVALID
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  return s;
}

// Squared l2 distance between two rows of m floats, computed by one warp;
// every lane returns the full sum.  vec4 selects 16-byte loads (m % 4 == 0
// and both rows 16-byte aligned).
__device__ __forceinline__ float warp_sq_l2(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int m, bool vec4, int lane) {
  float s = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = lane; i < (m >> 2); i += 32) {
      float4 x = __ldg(a4 + i);
      float4 y = __ldg(b4 + i);
      float dx = x.x - y.x, dy = x.y - y.y, dz = x.z - y.z, dw = x.w - y.w;
      s = fmaf(dx, dx, s);
      s = fmaf(dy, dy, s);
      s = fmaf(dz, dz, s);
      s = fmaf(dw, dw, s);
    }
  } else {
    for (int i = lane; i < m; i += 32) {
      float dx = __ldg(a + i) - __ldg(b + i);
      s = fmaf(dx, dx, s);
    }
  }
  return warp_sum(s);
}

__device__ __forceinline__ float finish_dist(float s, bool squared) {
  s = fmaxf(s, 0.f);
  return squared ? s : sqrtf(s);
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
