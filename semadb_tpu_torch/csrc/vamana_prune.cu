// K11: the Vamana robust prune, one block a node, for Hopper.
//
// Replaces the XLA programs of semadb_tpu/index/vamana/build.py ·
// robust_prune_batch (:97-156), the greedy alpha prune of robustPrune
// (search.go:106-138), together with _pairwise_among (:72-94), the f32[B, P, P]
// matrix of distances among each node's candidates that feeds it.
//
//   cand_d f32[B, P] (sorted ascending) x cand_i i32[B, P] x self_ids i32[B]
//   x vectors f32[cap, D] x alpha -> adjacency rows i32[B, R]
//
// Semantics, as the JAX program's: a candidate is dead from the start when its
// id is -1 or the node's own, or its distance is not finite. While the node
// has fewer than r_stop = max(R - FWD_SLACK, 8) edges and a live candidate is
// left, the first live one (pos) becomes the next edge and is consumed, and
// every later candidate j with alpha * pd(pos, j) < cand_d[j] dies. The rest
// of the row is -1. pd is _pairwise_among's formula, so that the decisions
// are the plain version's: euclidean sq_pos + sq_j - 2 <pos, j> (rounded as
// (sq_pos - 2 cross) + sq_j) clamped at 0, cosine 1 - <pos, j>, dot
// -<pos, j>, haversine _haversine_pair(pos, j) in meters with each product
// and sum rounded as PyTorch rounds it. Candidate rows are read at their ids
// clipped to [0, cap).
//
// What bounds it on the H100: bytes, at the build's shapes. The least traffic
// is each distinct live candidate's row once for the whole batch (at most
// P x D x 4 bytes a pool, 115 KB at P = 224, D = 128; pools of one batch share
// rows) plus the pools and the rows written (tools/vamana_operands.py
// k11_least_bytes); the arithmetic, D multiply-adds for each
// pair (kept candidate, later live candidate), is at most R x P x D a node
// (1.8 M at R = 64), some 4 operations a byte.
//
// What the design does about it. This is the first, simple design. The JAX
// program computes all P x P distances; here a distance is computed only from
// a kept candidate to the live candidates after it, so at most R rows of the
// matrix, and no matrix is written. One block of 256 threads a node stages the
// rows of its live candidates in shared memory once (coalesced, a row stride
// of D + 1 floats so that the threads, one a candidate, read distinct banks)
// when they fit in kStageBytes, and else reads them from device memory where
// they lie (L2 serves the repeats). Each step finds the first live candidate
// with a shared atomicMin, then each thread scores its candidates against it.
// Not done yet: the steps are serial, one __syncthreads apart, and a thread
// owns whole rows (no tensor cores, no split of D across lanes).
// P <= 2048, D <= 4096.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vamana_common.cuh"

namespace {

using namespace vamana;

constexpr int kThreads = 256;
constexpr int kMaxP = 2048;
constexpr int kMaxD = 4096;
constexpr long long kStageBytes = 200 * 1024;  // rows staged in shared memory up to this
__device__ __forceinline__ float dot_rows(const float* a, const float* b, int D) {
  float acc = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) acc += a[d] * b[d];
  return acc;
}

// The first live position at or after `from`, or P (every thread gets it)
__device__ int first_live(const int* dead, int from, int P, int* next) {
  __syncthreads();
  if (threadIdx.x == 0) *next = P;
  __syncthreads();
  for (int j = from + threadIdx.x; j < P; j += kThreads) {
    if (!dead[j]) {
      atomicMin(next, j);
      break;
    }
  }
  __syncthreads();
  return *next;
}

__global__ void __launch_bounds__(kThreads) vamana_robust_prune_kernel(
    const float* __restrict__ vectors, long long cap, int D, const float* __restrict__ cand_d,
    const int32_t* __restrict__ cand_i, const int32_t* __restrict__ self_ids, int P, int R, int r_stop,
    float alpha, int metric, int staged, int32_t* __restrict__ out_adj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sd = reinterpret_cast<float*>(smem_raw);        // [P] candidate distances
  int* si = reinterpret_cast<int*>(sd + P);               // [P] ids
  int* dead = si + P;                                     // [P]
  float* sq = reinterpret_cast<float*>(dead + P);         // [P] squared norms (euclidean)
  int* adj = reinterpret_cast<int*>(sq + P);              // [R]
  int* misc = adj + R;                                    // [4]
  float* rows = reinterpret_cast<float*>(misc + 4);       // [P, D + 1] when staged
  const int b = blockIdx.x;
  const int self = self_ids[b];
  const float* gd = cand_d + (long long)b * P;
  const int32_t* gi = cand_i + (long long)b * P;
  for (int j = threadIdx.x; j < P; j += kThreads) {
    const float d = gd[j];
    const int id = gi[j];
    sd[j] = d;
    si[j] = id;
    dead[j] = id == kNil || id == self || !isfinite(d);
  }
  __syncthreads();
  const int stride = staged ? D + 1 : D;
  if (staged) {
    for (long long e = threadIdx.x; e < (long long)P * D; e += kThreads) {
      const int j = (int)(e / D), d = (int)(e % D);
      if (!dead[j]) {
        const int id = si[j];
        const long long row = id < 0 ? 0 : (id >= cap ? cap - 1 : id);
        rows[(long long)j * stride + d] = __ldg(vectors + row * D + d);
      }
    }
    __syncthreads();
  }
  auto row_of = [&](int j) -> const float* {
    if (staged) return rows + (long long)j * stride;
    const int id = si[j];
    const long long row = id < 0 ? 0 : (id >= cap ? cap - 1 : id);
    return vectors + row * D;
  };
  if (metric == kEuclidean) {
    for (int j = threadIdx.x; j < P; j += kThreads) {
      if (!dead[j]) {
        const float* v = row_of(j);
        sq[j] = dot_rows(v, v, D);
      }
    }
  }
  int count = 0;
  int pos = first_live(dead, 0, P, &misc[0]);
  while (pos < P && count < r_stop) {
    if (threadIdx.x == 0 && count < R) adj[count] = si[pos];  // past R, JAX's one_hot writes nothing
    ++count;
    const float* vp = row_of(pos);
    for (int j = pos + 1 + threadIdx.x; j < P; j += kThreads) {
      if (dead[j]) continue;
      const float* vj = row_of(j);
      float pd;
      if (metric == kHaversine) {
        pd = haversine(vp[0], vp[1], vj[0], vj[1]);
      } else {
        const float cross = dot_rows(vp, vj, D);
        if (metric == kEuclidean) {
          pd = fmaxf(__fadd_rn(__fsub_rn(sq[pos], __fmul_rn(2.0f, cross)), sq[j]), 0.0f);
        } else if (metric == kCosine) {
          pd = __fsub_rn(1.0f, cross);
        } else {
          pd = -cross;
        }
      }
      if (__fmul_rn(alpha, pd) < sd[j]) dead[j] = 1;
    }
    pos = first_live(dead, pos + 1, P, &misc[0]);
  }
  __syncthreads();
  int32_t* out = out_adj + (long long)b * R;
  for (int r = threadIdx.x; r < R; r += kThreads) out[r] = r < count ? adj[r] : kNil;  // count may pass R
}

long long smem_bytes(int D, int P, int R, bool staged) {
  long long base = 4LL * (4LL * P + R + 4);
  base = (base + 15) & ~15LL;
  return base + (staged ? 4LL * P * (D + 1) : 0);
}

// True when the kernel stages the candidates' rows in shared memory at this D and P.
bool prune_staged(int D, int P, int R) { return smem_bytes(D, P, R, true) <= kStageBytes; }

}  // namespace

extern "C" {

// Pointers are device pointers. metric: 0 euclidean, 1 dot, 2 cosine, 3
// haversine. Returns cudaGetLastError() after the launch (0 on success).
// Launches on `stream`; does not synchronise.
int semadb_vamana_robust_prune(const void* vectors, long long cap, int D, const void* cand_d,
                               const void* cand_i, const void* self_ids, int B, int P, int R, int r_stop,
                               float alpha, int metric, void* out_adj, void* stream) {
  if (cap < 1 || D < 1 || D > kMaxD || B < 1 || P < 1 || P > kMaxP || R < 1 || r_stop < 0 || metric < 0 ||
      metric > 3 || (metric == kHaversine && D != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool staged = prune_staged(D, P, R);
  const long long smem = smem_bytes(D, P, R, staged);
  cudaError_t err = cudaFuncSetAttribute(vamana_robust_prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  vamana_robust_prune_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), cap, D, static_cast<const float*>(cand_d),
      static_cast<const int32_t*>(cand_i), static_cast<const int32_t*>(self_ids), P, R, r_stop, alpha, metric,
      staged, static_cast<int32_t*>(out_adj));
  return (int)cudaGetLastError();
}

const char* semadb_vamana_prune_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
