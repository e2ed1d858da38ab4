// K9: the ADC scan of product-quantized codes, for Hopper.
//
// Replaces the XLA programs of semadb_tpu/index/ivf.py · _ivf_query_pq that
// score the probed code slabs (:579-605: slab_codes[probe] gathered into
// [B, pchunk, S, M], a flat take_along_axis into the [B, M * K] tables, a
// sum over m) and take the pool (top_k over [B, p * S + O]), and of
// semadb_tpu/vectorstore/store.py · pq_scan_distance (:330-347). ADC: query b
// has a table f32[M, K] (each subvector's distance to each of the K
// centroids), and a row with codes u8[M] scores sum_m table[b, m, code[m]].
//
// Two entries, one query a block:
//   probed  table f32[B, M, K] x probe i32[B, p] x slab_codes u8[C, S, M]
//           x slab_ids i32[C, S] (x mask u8[mask_len])
//           -> the rr smallest scores over the probed slots whose id is not
//              -1 (and is allowed by the mask), ascending, as out_d f32[B, rr]
//              and out_i i32[B, rr]; unfilled places (inf, -1). Probe entries
//              outside [0, C) are skipped; a cluster probed twice counts
//              twice, as in the JAX program.
//   dense   table f32[B, M, K] x codes u8[N, M] (x mask u8[N])
//           -> out f32[B, N], +inf where the mask is 0.
//
// What bounds it on the H100: bytes. A slot costs M table lookups and adds
// against M + 4 bytes of codes and id; the lookups hit shared memory. The
// least traffic reads each query's table once, each distinct probed
// cluster's ids once and the codes of its live slots once, and writes the
// pool. At the IVF-PQ bench cell (1M x 128, M = 8, K = 256, S = 128, p = 24,
// B = 4,096) the whole code array is 33.5 MB and fits the 50 MB L2, so a
// query-major design that reads a probed cluster once per query that probes
// it pays for the rereads in L2 bandwidth, not in HBM bytes; a cluster-major
// design would instead reload the 8 KB table of each query for every cluster
// it probes.
//
// So the design is query-major. A block of 256 threads takes one query: it
// stages the query's table in shared memory (M * K * 4 bytes, 8 KB at the
// cell, at most 128 KB at M = 128, K = 256), then scores the query's p * S
// probed slots one a thread, 1,024 at a time: a live, allowed slot reads its
// M code bytes with the widest load the row's alignment allows (16, 8, 4 or
// 1 bytes) and sums M lookups in f32, m = 0 .. M - 1. Dead slots read no
// codes. The scores go through the running top-rr that K3's merge keeps
// (ivf_common.cuh): pairs at or under the bound are appended to a shared
// buffer, sorted by a bitonic network and cut to rr when the next tile might
// not fit, after which the bound is the rr-th kept score. Only the rr kept
// slots look up their ids. The dense entry stages the table once per block
// of 2,048 rows and writes each row's score, coalesced.
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include <string.h>

#include <type_traits>

#include "ivf_common.cuh"

namespace {

constexpr int kThreads = ivf::kThreads;
constexpr int kUnroll = 4;                  // slots a thread scores between two looks at the buffer
constexpr int kTile = kThreads * kUnroll;   // the wrapper's TILE
constexpr int kDenseRows = 8;               // rows a thread of the dense entry scores
constexpr int kMaxRr = 2048;
constexpr int kMaxK = 256;

// sum_m tab[m * K + row[m]] over the M code bytes at row, read W bytes at a
// time (row is W-byte aligned; W in {1, 4, 8, 16} and M % W == 0).
template <int W>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row, const float* tab, int M, int K) {
  float s = 0.f;
  if constexpr (W == 1) {
    for (int m = 0; m < M; ++m) s += tab[m * K + __ldg(row + m)];
  } else {
    using Vec = typename std::conditional<W == 16, uint4, typename std::conditional<W == 8, uint2, unsigned>::type>::type;
    const Vec* rv = reinterpret_cast<const Vec*>(row);
    for (int u = 0; u < M / W; ++u) {
      const Vec v = __ldg(rv + u);
      unsigned w[W / 4];
      memcpy(w, &v, W);
      const float* t = tab + u * W * K;
#pragma unroll
      for (int e = 0; e < W; ++e) s += t[e * K + ((w[e >> 2] >> (8 * (e & 3))) & 0xffu)];
    }
  }
  return s;
}

// Stage query b's table in shared memory.
__device__ __forceinline__ void stage_table(const float* __restrict__ table, long long b, int mk, float* tab) {
  const float* qt = table + b * mk;
  for (int i = threadIdx.x; i < mk; i += blockDim.x) tab[i] = __ldg(qt + i);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pq_probe_scan_kernel(const float* __restrict__ table, const int32_t* __restrict__ probe,
                     const uint8_t* __restrict__ codes, const int32_t* __restrict__ slab_ids,
                     const uint8_t* __restrict__ mask, long long mask_len, int p, int C, int S, int M, int K,
                     int rr, int nbuf, float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);  // [M * K]
  float* bd = tab + M * K;                       // [nbuf] scores
  int* bi = reinterpret_cast<int*>(bd + nbuf);   // [nbuf] the slot: j * S + s of the query's probed list
  __shared__ int count, kept;
  __shared__ float thresh;
  const long long b = blockIdx.x;
  const int32_t* mine = probe + b * p;
  stage_table(table, b, M * K, tab);
  if (threadIdx.x == 0) {
    count = 0;
    kept = 0;
    thresh = ivf::inf_f();
  }
  __syncthreads();
  const int total = p * S;
  float th = ivf::inf_f();
  for (int base = 0; base < total; base += kTile) {
    th = ivf::make_room(bd, bi, rr, kTile, nbuf, &count, &kept, &thresh, th);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = base + i * kThreads + threadIdx.x;
      float d = ivf::inf_f();
      if (t < total) {
        const int j = t / S;
        const int c = __ldg(mine + j);
        if (c >= 0 && c < C) {
          const long long slot = (long long)c * S + (t - j * S);
          const int id = __ldg(slab_ids + slot);
          if (id >= 0 && (mask == nullptr || (id < mask_len && __ldg(mask + id)))) {
            d = adc_row<W>(codes + slot * M, tab, M, K);
          }
        }
      }
      ivf::warp_append(d <= th && d < ivf::inf_f(), d, t, &count, bd, bi);
    }
    __syncthreads();
  }
  ivf::keep_top(bd, bi, rr, &count, &kept, &thresh);
  for (int i = threadIdx.x; i < rr; i += blockDim.x) {
    float d = ivf::inf_f();
    int id = -1;
    if (i < kept) {
      const int t = bi[i], j = t / S;
      d = bd[i];
      id = __ldg(slab_ids + (long long)__ldg(mine + j) * S + (t - j * S));
    }
    out_d[b * rr + i] = d;
    out_i[b * rr + i] = id;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pq_scan_dense_kernel(const float* __restrict__ table, const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ mask, long long N, int M, int K, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);  // [M * K]
  const long long b = blockIdx.x;
  stage_table(table, b, M * K, tab);
  __syncthreads();
  const long long row0 = (long long)blockIdx.y * kThreads * kDenseRows;
#pragma unroll
  for (int i = 0; i < kDenseRows; ++i) {
    const long long n = row0 + i * kThreads + threadIdx.x;
    if (n < N) {
      float d = ivf::inf_f();
      if (mask == nullptr || __ldg(mask + n)) d = adc_row<W>(codes + n * M, tab, M, K);
      out[b * N + n] = d;
    }
  }
}

// The widest load (16, 8, 4 or 1 bytes) that every row of M code bytes from
// base can take.
inline int load_width(const void* base, int M) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w >= 4; w >>= 1) {
    if (M % w == 0 && a % w == 0) return w;
  }
  return 1;
}

template <int W>
cudaError_t launch_probed(const float* table, const int32_t* probe, const uint8_t* codes, const int32_t* slab_ids,
                          const uint8_t* mask, long long mask_len, int B, int p, int C, int S, int M, int K,
                          int rr, int nbuf, float* out_d, int32_t* out_i, cudaStream_t stream) {
  const size_t smem = ((size_t)M * K + 2 * (size_t)nbuf) * 4;
  const cudaError_t e =
      cudaFuncSetAttribute(pq_probe_scan_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  pq_probe_scan_kernel<W><<<B, kThreads, smem, stream>>>(table, probe, codes, slab_ids, mask, mask_len, p, C, S, M,
                                                           K, rr, nbuf, out_d, out_i);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dense(const float* table, const uint8_t* codes, const uint8_t* mask, int B, long long N, int M,
                         int K, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * 4;
  const cudaError_t e =
      cudaFuncSetAttribute(pq_scan_dense_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (N + kThreads * kDenseRows - 1) / (kThreads * kDenseRows);
  pq_scan_dense_kernel<W><<<dim3(B, (unsigned)tiles), kThreads, smem, stream>>>(table, codes, mask, N, M, K, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers are device pointers; mask may be null (no filter). nbuf is the
// selection buffer's length: a power of two >= rr + 1,024. Returns the first
// CUDA error of the launch (0 on success). Launches on `stream`; does not
// synchronise.
int semadb_pq_probe_scan(const void* table, const void* probe, const void* slab_codes, const void* slab_ids,
                         const void* mask, long long mask_len, int B, int p, int C, int S, int M, int K, int rr,
                         int nbuf, void* out_d, void* out_i, void* stream) {
  if (B <= 0 || p < 0 || C <= 0 || S <= 0 || M <= 0 || K <= 0 || K > kMaxK || rr <= 0 || rr > kMaxRr ||
      nbuf < rr + kTile || (nbuf & (nbuf - 1)) != 0 || (long long)p * S > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* t = static_cast<const float*>(table);
  const auto* pr = static_cast<const int32_t*>(probe);
  const auto* c = static_cast<const uint8_t*>(slab_codes);
  const auto* ids = static_cast<const int32_t*>(slab_ids);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int32_t*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (load_width(slab_codes, M)) {
    case 16: return (int)launch_probed<16>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, nbuf, od, oi, s);
    case 8: return (int)launch_probed<8>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, nbuf, od, oi, s);
    case 4: return (int)launch_probed<4>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, nbuf, od, oi, s);
    default: return (int)launch_probed<1>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, nbuf, od, oi, s);
  }
}

// Dense entry: out f32[B, N]. Same conventions.
int semadb_pq_scan_dense(const void* table, const void* codes, const void* mask, int B, long long N, int M, int K,
                         void* out, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || K <= 0 || K > kMaxK ||
      (N + kThreads * kDenseRows - 1) / (kThreads * kDenseRows) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* t = static_cast<const float*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (load_width(codes, M)) {
    case 16: return (int)launch_dense<16>(t, c, mk, B, N, M, K, o, s);
    case 8: return (int)launch_dense<8>(t, c, mk, B, N, M, K, o, s);
    case 4: return (int)launch_dense<4>(t, c, mk, B, N, M, K, o, s);
    default: return (int)launch_dense<1>(t, c, mk, B, N, M, K, o, s);
  }
}

const char* semadb_pq_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
