// K4: IVF exact rerank of the coarse pool, for Hopper.
//
// Replaces the XLA program of semadb_tpu/index/ivf.py · _ivf_query that
// reranks the pool (:517-543: vectors[pool] gathered as [B, rr, D] (or in
// chunks of 64), the exact f32 metric, top_k, (inf, -1) for empty slots).
//
//   vectors f32[cap, D] x queries f32[B, D] x pool i32[B, rr]
//   x coarse f32[B, rr] -> the k smallest exact distances, ascending by
//      (d, id), as out_d f32[B, k] and out_i i32[B, k]
//
// A pool slot is empty when its coarse score is not finite or its id lies
// outside [0, cap) (the JAX program clips such ids and masks -1; every id the
// engine hands over is in range). Metrics as the engine defines them:
// euclidean sum (x - q)^2 (taken directly, not by the norm expansion), dot
// -sum x q, cosine 1 - sum x q. Empty and unfilled slots come out (inf, -1).
//
// What bounds it on the H100: bytes. D multiply-adds per 4 D bytes of
// gathered row. The least traffic is each distinct pool row once, plus the
// queries, the pool and the output: ~0.14 GB a 4096-query batch at the
// 1M x 128 cell, ~0.04 ms.
//
// What the design does about it:
//   - one block per query, its row in shared memory; a team of lanes per
//     pool entry gathers the row straight from `vectors` with 16-byte loads
//     (element loads off the 16-byte grid) and an f32 accumulator, looping
//     over D, so no [B, rr, D] intermediate exists (6.4 GB at 1M x 1536-d in
//     the unchunked JAX form);
//   - the rr distances stay in shared memory and a bitonic sort by (d, id)
//     selects the k smallest (k may exceed rr: the rest is (inf, -1)).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include "ivf_common.cuh"

namespace {

constexpr int kEuclidean = 0, kDot = 1, kCosine = 2;
constexpr int kMaxPool = 2048;

template <bool kVec, int kMetric>
__global__ void __launch_bounds__(ivf::kThreads)
rerank_kernel(const float* __restrict__ vectors, long long cap, int D,
              const float* __restrict__ queries, const int32_t* __restrict__ pool,
              const float* __restrict__ coarse, int rr, int P, int k,
              float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dpad = (D + 7) & ~7;
  float* q = reinterpret_cast<float*>(smem);
  float* bd = q + dpad;
  int* bi = reinterpret_cast<int*>(bd + P);
  const float inf = __int_as_float(0x7f800000);

  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < dpad; e += blockDim.x) q[e] = e < D ? queries[b * D + e] : 0.f;
  for (int i = rr + threadIdx.x; i < P; i += blockDim.x) {
    bd[i] = inf;
    bi[i] = INT_MAX;
  }
  __syncthreads();

  const int units = kVec ? D / 4 : D;
  const int ts = ivf::team_size(units);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tl = lane & (ts - 1), team = lane / ts;
  const int teams_per_warp = 32 / ts;
  const int rows_per_pass = ivf::kWarps * teams_per_warp;
  for (int base = warp * teams_per_warp; base < rr; base += rows_per_pass) {
    const int j = base + team;
    int id = -1;
    if (j < rr) {
      id = __ldg(pool + b * rr + j);
      if (id < 0 || id >= cap || !isfinite(__ldg(coarse + b * rr + j))) id = -1;
    }
    const float part =
        id != -1 ? ivf::row_partial<kVec, false, kMetric == kEuclidean>(vectors + (long long)id * D,
                                                                          q, D, tl, ts)
                 : 0.f;
    const float s = ivf::team_sum(part, ts);
    if (j < rr && tl == 0) {
      bd[j] = id == -1 ? inf : (kMetric == kEuclidean ? s : kMetric == kCosine ? 1.f - s : -s);
      bi[j] = id == -1 ? INT_MAX : id;
    }
  }
  __syncthreads();
  ivf::bitonic_sort(bd, bi, P);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const bool ok = i < P && isfinite(bd[i]);
    out_d[b * k + i] = ok ? bd[i] : inf;
    out_i[b * k + i] = ok ? bi[i] : -1;
  }
}

template <bool kVec, int kMetric>
cudaError_t launch(const float* vectors, long long cap, int D, const float* queries,
                   const int32_t* pool, const float* coarse, int B, int rr, int k, float* out_d,
                   int32_t* out_i, cudaStream_t stream) {
  const int P = ivf::pow2_at_least(rr);
  const size_t smem = (size_t)(((D + 7) & ~7) + 2 * P) * 4;
  cudaError_t e = cudaFuncSetAttribute(rerank_kernel<kVec, kMetric>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rerank_kernel<kVec, kMetric><<<B, ivf::kThreads, smem, stream>>>(
      vectors, cap, D, queries, pool, coarse, rr, P, k, out_d, out_i);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t by_metric(int metric, const float* vectors, long long cap, int D, const float* queries,
                      const int32_t* pool, const float* coarse, int B, int rr, int k, float* out_d,
                      int32_t* out_i, cudaStream_t stream) {
  switch (metric) {
    case kEuclidean:
      return launch<kVec, kEuclidean>(vectors, cap, D, queries, pool, coarse, B, rr, k, out_d, out_i, stream);
    case kDot:
      return launch<kVec, kDot>(vectors, cap, D, queries, pool, coarse, B, rr, k, out_d, out_i, stream);
    case kCosine:
      return launch<kVec, kCosine>(vectors, cap, D, queries, pool, coarse, B, rr, k, out_d, out_i, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Pointers are device pointers. metric: 0 euclidean, 1 dot, 2 cosine.
// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream`; does not synchronise.
int semadb_ivf_exact_rerank(const void* vectors, long long cap, int D, const void* queries,
                            const void* pool, const void* coarse, int B, int rr, int k, int metric,
                            void* out_d, void* out_i, void* stream) {
  if (cap <= 0 || D <= 0 || D > 4096 || B <= 0 || rr <= 0 || rr > kMaxPool || k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  const float* v = static_cast<const float*>(vectors);
  const float* q = static_cast<const float*>(queries);
  const int32_t* pl = static_cast<const int32_t*>(pool);
  const float* c = static_cast<const float*>(coarse);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? by_metric<true>(metric, v, cap, D, q, pl, c, B, rr, k, od, oi, s)
                   : by_metric<false>(metric, v, cap, D, q, pl, c, B, rr, k, od, oi, s));
}

const char* semadb_ivf_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
