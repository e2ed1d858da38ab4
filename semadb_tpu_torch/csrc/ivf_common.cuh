// Pieces shared by the IVF query kernels K3 (ivf_scan.cu) and K4
// (ivf_rerank.cu): the team of lanes that scores one row, bf16 unpacking,
// the bitonic sort, and the running top-rr that K3's merge keeps in shared
// memory (warp_append, keep_top, make_room). K9 (ivf_pq_scan.cu) keeps its
// own selection.
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

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Append (d, id) to the shared buffer when take: one atomic per warp. Every
// lane of the warp calls it.
__device__ __forceinline__ void warp_append(bool take, float d, int id, int* count, float* bd, int* bi) {
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) {
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    bd[pos] = d;
    bi[pos] = id;
  }
}

// Sort the count appended pairs and cut to rr: the block's running top-rr,
// with thresh its rr-th score once rr are kept (else inf). The buffer holds
// at least the next power of two of count. Every thread calls it between two
// __syncthreads().
__device__ __forceinline__ void keep_top(float* bd, int* bi, int rr, int* count, int* kept, float* thresh) {
  const int n = *count;
  if (n > *kept) {
    int P = 1;
    while (P < n) P <<= 1;
    for (int i = n + threadIdx.x; i < P; i += blockDim.x) {
      bd[i] = inf_f();
      bi[i] = INT_MAX;
    }
    __syncthreads();
    bitonic_sort(bd, bi, P);
    if (threadIdx.x == 0) {
      *kept = n < rr ? n : rr;
      *count = *kept;
      *thresh = *kept == rr ? bd[rr - 1] : inf_f();
    }
  }
  __syncthreads();
}

// Before a step that appends up to `step` pairs to a buffer of nbuf: cut it
// to the running top-rr when the appends might not fit, and return the bound
// to append under (th, lowered to the rr-th kept score after a cut). Every
// thread reads count before any thread appends again, so all take the same
// branch (a warp that appended before a slower one read count would split
// the block at keep_top's barriers). Every thread calls it.
__device__ __forceinline__ float make_room(float* bd, int* bi, int rr, int step, int nbuf, int* count, int* kept,
                                           float* thresh, float th) {
  const bool cut = *count + step > nbuf;
  __syncthreads();
  if (cut) {
    keep_top(bd, bi, rr, count, kept, thresh);
    th = fminf(th, *thresh);  // both bound the rr-th score from above
  }
  return th;
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace ivf
