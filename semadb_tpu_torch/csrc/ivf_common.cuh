// Pieces shared by the IVF query kernels K3 (ivf_scan.cu) and K4
// (ivf_rerank.cu): the team that scores one row, and the bitonic sort that
// selects in shared memory.
//
// A "team" is ts lanes of one warp (ts a power of two, 1..32) that score one
// row together: each lane takes every ts-th unit of the row (a unit is 16
// bytes on the vector path, one element on the scalar path), keeps an f32
// partial sum, and the team adds the partials with xor shuffles. Every lane
// of the warp calls team_sum the same number of times (callers keep their
// loops warp-uniform and give idle lanes a partial of 0), so the full-warp
// shuffle mask is always right.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace ivf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int team_size(int units) {
  int t = 1;
  while (t < units && t < 32) t <<= 1;
  return t;
}

__device__ __forceinline__ float team_sum(float v, int ts) {
  for (int off = ts >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <bool kSqDiff>
__device__ __forceinline__ float term(float x, float q) {
  if (kSqDiff) {
    const float t = x - q;
    return t * t;
  }
  return x * q;
}

// This lane's partial sum over one row of n elements against q (f32 in
// shared memory, 16-byte aligned, padded to a multiple of 8 floats):
// sum of x*q, or of (x - q)^2 with kSqDiff. kVec reads 16-byte units (the
// row must be 16-byte aligned and n * sizeof(elem) a multiple of 16); kBf16
// reads bf16 elements, else f32.
template <bool kVec, bool kBf16, bool kSqDiff>
__device__ __forceinline__ float row_partial(const void* row, const float* q, int n, int tl,
                                             int ts) {
  float acc = 0.f;
  if (kVec) {
    const uint4* r4 = static_cast<const uint4*>(row);
    const int units = kBf16 ? n / 8 : n / 4;
    for (int u = tl; u < units; u += ts) {
      const uint4 v = __ldg(r4 + u);
      if (kBf16) {
        const float4 a = reinterpret_cast<const float4*>(q)[2 * u];
        const float4 b = reinterpret_cast<const float4*>(q)[2 * u + 1];
        acc += term<kSqDiff>(bf16_lo(v.x), a.x) + term<kSqDiff>(bf16_hi(v.x), a.y) +
               term<kSqDiff>(bf16_lo(v.y), a.z) + term<kSqDiff>(bf16_hi(v.y), a.w) +
               term<kSqDiff>(bf16_lo(v.z), b.x) + term<kSqDiff>(bf16_hi(v.z), b.y) +
               term<kSqDiff>(bf16_lo(v.w), b.z) + term<kSqDiff>(bf16_hi(v.w), b.w);
      } else {
        const float4 a = reinterpret_cast<const float4*>(q)[u];
        acc += term<kSqDiff>(__uint_as_float(v.x), a.x) + term<kSqDiff>(__uint_as_float(v.y), a.y) +
               term<kSqDiff>(__uint_as_float(v.z), a.z) + term<kSqDiff>(__uint_as_float(v.w), a.w);
      }
    }
  } else if (kBf16) {
    const uint16_t* r = static_cast<const uint16_t*>(row);
    for (int e = tl; e < n; e += ts) acc += term<kSqDiff>(__uint_as_float((uint32_t)__ldg(r + e) << 16), q[e]);
  } else {
    const float* r = static_cast<const float*>(row);
    for (int e = tl; e < n; e += ts) acc += term<kSqDiff>(__ldg(r + e), q[e]);
  }
  return acc;
}

// Ascending sort of n (a power of two) (d, id) pairs in shared memory, by d
// and then id, so equal distances come out in one order on every run. Every
// thread of the block calls it; it ends with __syncthreads().
__device__ inline void bitonic_sort(float* d, int* id, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const float di = d[i], dp = d[p];
          const int ii = id[i], ip = id[p];
          const bool greater = di > dp || (di == dp && ii > ip);
          if (greater == ((i & k) == 0)) {
            d[i] = dp;
            d[p] = di;
            id[i] = ip;
            id[p] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace ivf
