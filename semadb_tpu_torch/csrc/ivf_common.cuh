// Pieces shared by the IVF query kernels K3 (ivf_scan.cu) and K4
// (ivf_rerank.cu): the team of lanes that scores one row, bf16 unpacking,
// and the bitonic sort that selects in shared memory.
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
