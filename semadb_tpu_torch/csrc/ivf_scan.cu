// K3: IVF probed-slab scan with a running top-rr, for Hopper.
//
// Replaces the XLA program of semadb_tpu/index/ivf.py · _ivf_query that
// scores the probed slabs (:428-442: slabs[probe] gathered probe chunk by
// probe chunk into [B, pchunk, S, r], one einsum against the projected
// queries) and takes the coarse pool (:507-509: top_k over [B, p*S + O]).
//
//   qp f32[B, r] x probe i32[B, p] x slabs f32|bf16[C, S, r]
//   x slab_sq f32[C, S] x slab_ids i32[C, S] (x mask u8[mask_len])
//   -> the rr smallest d = slab_sq - 2 <slab row, qp> over the probed slots
//      whose id is not -1 (and is allowed by the mask), ascending by (d, id),
//      as out_d f32[B, rr] and out_i i32[B, rr]; unfilled slots (inf, -1).
//
// What bounds it on the H100: bytes. Each probed slot costs r multiply-adds
// against r * 2-4 bytes of slab row, far below the card's ~20 flops a byte
// for f32 outside the tensor cores. The least traffic reads each distinct
// probed cluster's rows, norms and ids once per batch; this kernel reads a
// cluster once per query that probes it (L2 catches what concurrent blocks
// share), which is the next design's work.
//
// What the design does about it:
//   - one block per query, its qp in shared memory; the p*S probed slots are
//     walked as one flat list, consecutive slots to consecutive teams of a
//     warp, so a warp reads contiguous slab rows;
//   - a team of ts lanes scores a row with 16-byte loads (ts = the row's
//     16-byte units rounded up to a power of two, at most 32: a 512-byte f32
//     row of r = 128 is one load per lane of a warp, a bf16 one fills half a
//     warp), or with element loads when the row is not on the 16-byte grid
//     (r = 3, or bf16 with r % 8 != 0); accumulation is f32;
//   - a slot's id is read first: NIL and masked slots never read their row;
//   - candidates that beat the running rr-th distance are appended to a
//     shared buffer of NBUF pairs; after every NBUF - rr slots the buffer is
//     bitonic-sorted by (d, id) and cut to rr, so any p * S (up to numProbes
//     1024 x slabSize 1024) fits in fixed shared memory;
//   - ragged r and S need no padding: the loops stop at r and at p * S.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include "ivf_common.cuh"

namespace {

constexpr int kNbuf = 4096;  // candidate pairs in shared memory (a power of two)

template <bool kVec, bool kBf16>
__global__ void __launch_bounds__(ivf::kThreads)
probe_scan_kernel(const float* __restrict__ qp, const int32_t* __restrict__ probe,
                  const void* __restrict__ slabs, const float* __restrict__ slab_sq,
                  const int32_t* __restrict__ slab_ids, const uint8_t* __restrict__ mask,
                  long long mask_len, int p, int C, int S, int r, int rr,
                  float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rpad = (r + 7) & ~7;
  float* q = reinterpret_cast<float*>(smem);
  float* bd = q + rpad;
  int* bi = reinterpret_cast<int*>(bd + kNbuf);
  __shared__ int count, kept;
  __shared__ float thresh;

  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < rpad; e += blockDim.x) q[e] = e < r ? qp[b * r + e] : 0.f;
  if (threadIdx.x == 0) {
    count = 0;
    kept = 0;
    thresh = __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();

  const size_t elem = kBf16 ? 2 : 4;
  const int units = kVec ? (int)(r * elem / 16) : r;
  const int ts = ivf::team_size(units);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tl = lane & (ts - 1), team = lane / ts;
  const int teams_per_warp = 32 / ts;
  const int rows_per_pass = ivf::kWarps * teams_per_warp;
  const long long total = (long long)p * S;
  const int round = kNbuf - rr;
  const int32_t* my_probe = probe + b * p;

  for (long long t0 = 0; t0 < total; t0 += round) {
    const long long t1 = t0 + round < total ? t0 + round : total;
    const float th = thresh;
    for (long long base = t0 + (long long)warp * teams_per_warp; base < t1; base += rows_per_pass) {
      const long long t = base + team;
      int id = -1;
      float sq = 0.f;
      const unsigned char* row = nullptr;
      if (t < t1) {
        const int j = (int)(t / S), s = (int)(t - (long long)j * S);
        const int c = __ldg(my_probe + j);
        if (c >= 0 && c < C) {
          const long long cell = (long long)c * S + s;
          id = __ldg(slab_ids + cell);
          if (id != -1 && mask != nullptr && (id < 0 || id >= mask_len || !__ldg(mask + id))) id = -1;
          if (id != -1) {
            sq = __ldg(slab_sq + cell);
            row = static_cast<const unsigned char*>(slabs) + cell * r * elem;
          }
        }
      }
      const float part = id != -1 ? ivf::row_partial<kVec, kBf16, false>(row, q, r, tl, ts) : 0.f;
      const float dot = ivf::team_sum(part, ts);
      if (id != -1 && tl == 0) {
        const float d = sq - 2.f * dot;
        if (d < th) {
          const int pos = atomicAdd(&count, 1);
          bd[pos] = d;
          bi[pos] = id;
        }
      }
    }
    __syncthreads();
    const int n = count;
    if (n > kept) {
      int P = 1;
      while (P < n) P <<= 1;
      for (int i = n + threadIdx.x; i < P; i += blockDim.x) {
        bd[i] = __int_as_float(0x7f800000);
        bi[i] = INT_MAX;
      }
      __syncthreads();
      ivf::bitonic_sort(bd, bi, P);
      if (threadIdx.x == 0) {
        kept = n < rr ? n : rr;
        count = kept;
        thresh = kept == rr ? bd[rr - 1] : __int_as_float(0x7f800000);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rr; i += blockDim.x) {
    const bool ok = i < kept;
    out_d[b * rr + i] = ok ? bd[i] : __int_as_float(0x7f800000);
    out_i[b * rr + i] = ok ? bi[i] : -1;
  }
}

template <bool kVec, bool kBf16>
cudaError_t launch(const float* qp, const int32_t* probe, const void* slabs, const float* slab_sq,
                   const int32_t* slab_ids, const uint8_t* mask, long long mask_len, int B, int p,
                   int C, int S, int r, int rr, float* out_d, int32_t* out_i, cudaStream_t stream) {
  const size_t smem = (size_t)(((r + 7) & ~7) + 2 * kNbuf) * 4;
  cudaError_t e = cudaFuncSetAttribute(probe_scan_kernel<kVec, kBf16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  probe_scan_kernel<kVec, kBf16><<<B, ivf::kThreads, smem, stream>>>(
      qp, probe, slabs, slab_sq, slab_ids, mask, mask_len, p, C, S, r, rr, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers are device pointers; mask may be null (no filter). bf16 != 0
// means slabs hold bf16, else f32. Returns cudaGetLastError() after the
// launch (0 on success). Launches on `stream`; does not synchronise.
int semadb_ivf_probe_scan(const void* qp, const void* probe, const void* slabs,
                          const void* slab_sq, const void* slab_ids, const void* mask,
                          long long mask_len, int B, int p, int C, int S, int r, int bf16, int rr,
                          void* out_d, void* out_i, void* stream) {
  if (B <= 0 || p <= 0 || C <= 0 || S <= 0 || r <= 0 || r > 4096 || rr <= 0 ||
      rr > kNbuf / 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elem = bf16 ? 2 : 4;
  const bool vec = (r * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(slabs) % 16 == 0;
  const float* q = static_cast<const float*>(qp);
  const int32_t* pr = static_cast<const int32_t*>(probe);
  const float* sq = static_cast<const float*>(slab_sq);
  const int32_t* ids = static_cast<const int32_t*>(slab_ids);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = vec ? launch<true, true>(q, pr, slabs, sq, ids, m, mask_len, B, p, C, S, r, rr, od, oi, s)
            : launch<false, true>(q, pr, slabs, sq, ids, m, mask_len, B, p, C, S, r, rr, od, oi, s);
  } else {
    e = vec ? launch<true, false>(q, pr, slabs, sq, ids, m, mask_len, B, p, C, S, r, rr, od, oi, s)
            : launch<false, false>(q, pr, slabs, sq, ids, m, mask_len, B, p, C, S, r, rr, od, oi, s);
  }
  return (int)e;
}

const char* semadb_ivf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
