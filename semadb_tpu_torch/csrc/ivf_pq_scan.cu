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
// Two entries:
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
// What bounds it on the H100. The least traffic reads each query's table
// once, each distinct probed cluster's ids once and the codes of its live
// slots once, and writes the pool: 67 MB at the IVF-PQ bench cell (1M x 128,
// M = 8, K = 256, S = 128, p = 24, rr = 256, B = 4,096), 0.02 ms at 3.35 TB/s.
// The work is small too (~50 M shared-memory lookups there). What a design
// pays beyond that is latency: the selection of a query's rr smallest is a
// chain of steps that all of the query's threads wait on.
//
// The probed entry, one query a block of 256 threads. The block stages the
// query's table in shared memory (M * K * 4 bytes, 8 KB at the cell, at most
// 128 KB at M = 128, K = 256), then takes the query's p * S probed slots a
// chunk at a time (the whole list at the cell: 3,072 slots). Each thread
// scores two slots of the chunk at a time, their loads (the cluster, the id,
// the mask byte, the first code bytes) in flight together: a live, allowed
// slot reads its M code bytes with the widest load the row's alignment allows
// (16, 8, 4 or 1 bytes) and sums M lookups in f32, m = 0 .. M - 1; dead slots
// read no codes. A slot's score is
// kept as an order-preserving u32 key at its place in the chunk, so no slot
// index is stored. Then a radix select over the chunk's keys and the rr kept
// from earlier chunks finds the rr-th smallest: the keys' minimum and maximum
// give the bits they all share, and each pass histograms the next 8 bits of
// the keys that match the prefix found so far into 256 bins (one a thread)
// and a block scan picks the bin that holds the rr-th. A pass ends the search
// once its bin holds exactly the keys still wanted, or the key is complete
// (ties: any of the equal keys are taken, as many as are wanted). At the cell
// that is 2-3 passes of 12 keys a thread and a few barriers each, where a
// bitonic sort of a 2,048-entry append buffer would take 66 steps. A compaction keeps the
// keys under the cut (and the wanted ties) with their slots, each placed by
// one block scan of the threads' counts; later chunks drop at once every key
// above the kept set's cut. Only the kept rr are sorted, by key and slot: one
// a thread in registers, exchanged by warp shuffles, where they number 256 or
// fewer; else a bitonic network over the next power of two in shared memory.
// Only they look up their ids. A key is ~f for negative scores and f with the
// sign bit set otherwise, so negative tables order right; -0.0 sorts just
// below +0.0 (equal scores, either is right); +inf and NaN scores count as
// dead, as the plain version's (inf, -1) places.
//
// The dense entry stages the table once per block of 2,048 rows and writes
// each row's score, coalesced.
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "smem_optin.cuh"

namespace {

constexpr int kThreads = 256;               // a block; also the radix pass's bins
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;               // log2(kThreads)
constexpr int kUnroll = 2;                  // slots a thread scores at once
constexpr int kDenseRows = 8;               // rows a thread of the dense entry scores
constexpr int kMaxRr = 2048;
constexpr int kMaxK = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyInf = 0xff800000u;   // key of +inf: every live key lies below it
constexpr unsigned kKeyDead = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Order-preserving u32 key of a float: a < b iff key(a) < key(b) (not NaN).
__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The key's bits from `shift` up (0 for shift 32).
__device__ __forceinline__ unsigned high(unsigned k, int shift) { return shift >= 32 ? 0u : k >> shift; }

// A load of W code bytes (W in {1, 4, 8, 16}).
template <int W>
using CodeVec = typename std::conditional<
    W == 16, uint4,
    typename std::conditional<W == 8, uint2, typename std::conditional<W == 4, unsigned, uint8_t>::type>::type>::type;

// sum over the W code bytes in v of t[e * K + byte e]: W of a row's lookups,
// t the table from the first byte's subvector on.
template <int W>
__device__ __forceinline__ float adc_unit(const CodeVec<W>& v, const float* t, int K) {
  if constexpr (W == 1) {
    return t[v];
  } else {
    unsigned w[W / 4];
    memcpy(w, &v, W);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) s += t[e * K + ((w[e >> 2] >> (8 * (e & 3))) & 0xffu)];
    return s;
  }
}

// sum_m tab[m * K + row[m]] over the M code bytes at row, read W bytes at a
// time (row is W-byte aligned; M % W == 0), m = 0 .. M - 1 in f32; v0 holds
// the row's first W bytes, loaded ahead by the caller.
template <int W>
__device__ __forceinline__ float adc_row(const CodeVec<W>& v0, const uint8_t* __restrict__ row, const float* tab,
                                         int M, int K) {
  float s = adc_unit<W>(v0, tab, K);
  const CodeVec<W>* rv = reinterpret_cast<const CodeVec<W>*>(row);
  for (int u = 1; u < M / W; ++u) s += adc_unit<W>(__ldg(rv + u), tab + u * W * K, K);
  return s;
}

// Stage query b's table in shared memory.
__device__ __forceinline__ void stage_table(const float* __restrict__ table, long long b, int mk, float* tab) {
  const float* qt = table + b * mk;
  for (int i = threadIdx.x; i < mk; i += blockDim.x) tab[i] = __ldg(qt + i);
}

// What the threads of a probed block share besides the arrays.
struct Stats {
  unsigned lo, hi;        // the least and largest candidate key of a round
  int live;               // the chunk's candidates
  int digit, below, in_bin;  // the radix pass's bin, the keys under it, the keys in it
  unsigned warp_total[kWarps];
};

// Inclusive sum of v over the block's threads in thread order. Every thread
// calls it; it holds one barrier.
__device__ __forceinline__ unsigned block_inclusive_sum(unsigned v, Stats& st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) st.warp_total[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += st.warp_total[w];
  return v;
}

// Ascending sort of the block's kThreads (key, slot) pairs, one a thread,
// by key and then slot: a bitonic network whose steps exchange with
// __shfl_xor_sync within a warp (j < 32) and through xk, xs in shared memory
// across warps (j >= 32; 6 of its 36 steps). Every thread calls it.
__device__ __forceinline__ void block_sort(unsigned& key, int& slot, unsigned* xk, int* xs) {
  const int t = threadIdx.x;
  for (int k = 2; k <= kThreads; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned pk;
      int ps;
      if (j >= 32) {
        xk[t] = key;
        xs[t] = slot;
        __syncthreads();
        pk = xk[t ^ j];
        ps = xs[t ^ j];
        __syncthreads();
      } else {
        pk = __shfl_xor_sync(kFull, key, j);
        ps = __shfl_xor_sync(kFull, slot, j);
      }
      const bool partner_less = pk < key || (pk == key && ps < slot);
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      if (partner_less == keep_min) {
        key = pk;
        slot = ps;
      }
    }
  }
}

// Ascending sort of n (a power of two) (key, slot) pairs in shared memory,
// by key and then slot. Each step, a thread takes pairs (i, i + j) with bit j
// of i clear. Every thread calls it after a barrier; it ends with
// __syncthreads().
__device__ __forceinline__ void bitonic_sort(unsigned* key, int* slot, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int p = i | j;
        const unsigned ki = key[i], kp = key[p];
        const int si = slot[i], sp = slot[p];
        const bool greater = ki > kp || (ki == kp && si > sp);
        if (greater == ((i & k) == 0)) {
          key[i] = kp;
          key[p] = ki;
          slot[i] = sp;
          slot[p] = si;
        }
      }
      __syncthreads();
    }
  }
}

// One block a query. Shared memory: the table [M * K], the chunk's keys
// [chunk], and two kept sets of cap = the power of two >= rr (keys, slots):
// one is read while the compaction writes the other.
template <int W>
__global__ void __launch_bounds__(kThreads)
pq_probe_scan_kernel(const float* __restrict__ table, const int32_t* __restrict__ probe,
                     const uint8_t* __restrict__ codes, const int32_t* __restrict__ slab_ids,
                     const uint8_t* __restrict__ mask, long long mask_len, int p, int C, int S, int M, int K,
                     int rr, int chunk, int cap, float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);                   // [M * K]
  unsigned* ckey = reinterpret_cast<unsigned*>(tab + M * K);     // [chunk]
  unsigned* const kkeys = ckey + chunk;                           // [2][cap]
  int* const kslots = reinterpret_cast<int*>(kkeys + 2 * cap);    // [2][cap]
  __shared__ unsigned hist[kThreads];
  __shared__ Stats st;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const int32_t* mine = probe + b * p;
  stage_table(table, b, M * K, tab);
  const int total = p * S;
  const int step_j = kThreads / S, step_s = kThreads - step_j * S;  // kThreads slots on
  int cur = 0, nk = 0;         // the kept set in use and its entries
  unsigned bound = kKeyDead;   // no key above it can enter the kept set
  for (int base = 0; base < total; base += chunk) {
    __syncthreads();  // the table is staged; the last round's reads of st are done
    if (tid == 0) {
      st.lo = kKeyDead;
      st.hi = 0;
      st.live = 0;
    }
    const int n = min(chunk, total - base);
    unsigned lo = kKeyDead, hi = 0;
    int live = 0;
    // This thread's slots of the chunk are i = tid + u * kThreads; (j, s) is
    // slot base + i's probe and place in its cluster, advanced by kThreads
    // slots a step
    int j = (base + tid) / S, sj = base + tid - j * S;
    for (int i0 = tid; i0 < chunk; i0 += kUnroll * kThreads) {
      // kUnroll slots at once, each step's loads in flight together: the
      // cluster, the id, the mask byte, the first code bytes
      int slot[kUnroll], id[kUnroll];
      CodeVec<W> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        slot[u] = -1;
        if (i0 + u * kThreads < n) {
          const int c = __ldg(mine + j);
          if (c >= 0 && c < C) slot[u] = c * S + sj;
        }
        j += step_j;
        sj += step_s;
        if (sj >= S) {
          sj -= S;
          ++j;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) id[u] = slot[u] >= 0 ? __ldg(slab_ids + slot[u]) : -1;
      if (mask != nullptr) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (id[u] >= 0 && !(id[u] < mask_len && __ldg(mask + id[u]))) id[u] = -1;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (id[u] >= 0) v[u] = __ldg(reinterpret_cast<const CodeVec<W>*>(codes + (long long)slot[u] * M));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        unsigned key = kKeyDead;
        if (id[u] >= 0) {
          const float d = adc_row<W>(v[u], codes + (long long)slot[u] * M, tab, M, K);
          if (d < inf_f() && f2key(d) <= bound) key = f2key(d);
        }
        if (i < chunk) ckey[i] = key;
        if (key != kKeyDead) {
          lo = min(lo, key);
          hi = max(hi, key);
          ++live;
        }
      }
    }
    for (int i = tid; i < nk; i += kThreads) {
      const unsigned key = kkeys[cur * cap + i];
      lo = min(lo, key);
      hi = max(hi, key);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    live = __reduce_add_sync(kFull, live);
    __syncthreads();  // the resets of st are seen
    if (lane == 0) {
      atomicMin(&st.lo, lo);
      atomicMax(&st.hi, hi);
      atomicAdd(&st.live, live);
    }
    __syncthreads();
    const int cand = st.live + nk;
    // The cut: keys whose bits from `shift` up lie under cut's are kept, and
    // `need` of those equal to them
    unsigned cut = kKeyInf;
    int shift = 0, need = 0;
    if (cand > rr) {
      lo = st.lo;
      hi = st.hi;
      need = rr;
      cut = lo;
      if (lo != hi) {
        shift = 32 - __clz(lo ^ hi);  // the bits above it are every candidate's
        for (;;) {
          const int nb = min(kDigitBits, shift), ds = shift - nb;
          const unsigned want = high(cut, shift), digit_mask = (1u << nb) - 1u;
          hist[tid] = 0;
          __syncthreads();
          for (int i = tid; i < chunk; i += kThreads) {
            const unsigned key = ckey[i];
            if (key != kKeyDead && high(key, shift) == want) atomicAdd(&hist[(key >> ds) & digit_mask], 1u);
          }
          for (int i = tid; i < nk; i += kThreads) {
            const unsigned key = kkeys[cur * cap + i];
            if (high(key, shift) == want) atomicAdd(&hist[(key >> ds) & digit_mask], 1u);
          }
          __syncthreads();
          const unsigned h = hist[tid];
          const unsigned incl = block_inclusive_sum(h, st);
          if (incl - h < (unsigned)need && (unsigned)need <= incl) {
            st.digit = tid;
            st.below = (int)(incl - h);
            st.in_bin = (int)h;
          }
          __syncthreads();
          need -= st.below;
          cut = (shift >= 32 ? 0u : (cut >> shift) << shift) | ((unsigned)st.digit << ds);
          shift = ds;
          if (st.in_bin == need || shift == 0) break;
        }
      }
    }
    // Keep the keys under the cut and the first `need` of those equal to it,
    // placed by a block scan of each thread's counts of both (packed in the
    // halves of a u32; a round holds at most chunk + cap < 2^16 keys)
    const unsigned cut_high = high(cut, shift);
    const int dst = cur ^ 1;
    unsigned counts = 0;
    for (int i = tid; i < chunk; i += kThreads) {
      const unsigned key = ckey[i];
      if (key != kKeyDead) counts += high(key, shift) < cut_high ? 0x10000u : (high(key, shift) == cut_high);
    }
    for (int i = tid; i < nk; i += kThreads) {
      const unsigned key = kkeys[cur * cap + i];
      counts += high(key, shift) < cut_high ? 0x10000u : (high(key, shift) == cut_high);
    }
    const unsigned before = block_inclusive_sum(counts, st) - counts;
    const int n_below = cand > rr ? rr - need : cand;  // keys under the cut in the round
    int below = (int)(before >> 16), equal = (int)(before & 0xffffu);
    for (int i = tid; i < chunk + nk; i += kThreads) {  // chunk is a multiple of kThreads
      const bool kept = i >= chunk;
      const unsigned key = kept ? kkeys[cur * cap + i - chunk] : ckey[i];
      if (key == kKeyDead) continue;
      const unsigned kh = high(key, shift);
      int pos = -1;
      if (kh < cut_high) {
        pos = below++;
      } else if (kh == cut_high && equal++ < need) {
        pos = n_below + equal - 1;
      }
      if (pos >= 0) {
        kkeys[dst * cap + pos] = key;
        kslots[dst * cap + pos] = kept ? kslots[cur * cap + i - chunk] : base + i;
      }
    }
    __syncthreads();
    nk = min(cand, rr);
    cur = dst;
    // Once rr are kept, a key above the cut's bin can never enter
    if (cand > rr) bound = min(bound, cut | (shift == 0 ? 0u : (1u << shift) - 1u));
  }
  // Sort the kept entries and write them out: one a thread in registers
  // where they fit (the IVF-PQ cell's rr = 256), else padded to a power of
  // two in shared memory
  if (nk <= kThreads) {
    unsigned key = tid < nk ? kkeys[cur * cap + tid] : kKeyDead;
    int slot = tid < nk ? kslots[cur * cap + tid] : INT_MAX;
    block_sort(key, slot, ckey, reinterpret_cast<int*>(hist));
    if (tid < rr) {
      float d = inf_f();
      int id = -1;
      if (tid < nk) {
        const int j = slot / S;
        d = key2f(key);
        id = __ldg(slab_ids + (long long)__ldg(mine + j) * S + (slot - j * S));
      }
      out_d[b * rr + tid] = d;
      out_i[b * rr + tid] = id;
    }
    for (int i = kThreads + tid; i < rr; i += kThreads) {
      out_d[b * rr + i] = inf_f();
      out_i[b * rr + i] = -1;
    }
    return;
  }
  int np = 1;
  while (np < nk) np <<= 1;
  for (int i = nk + tid; i < np; i += kThreads) {
    kkeys[cur * cap + i] = kKeyDead;
    kslots[cur * cap + i] = INT_MAX;
  }
  __syncthreads();
  bitonic_sort(kkeys + cur * cap, kslots + cur * cap, np);
  for (int i = tid; i < rr; i += kThreads) {
    float d = inf_f();
    int id = -1;
    if (i < nk) {
      const int t = kslots[cur * cap + i], j = t / S;
      d = key2f(kkeys[cur * cap + i]);
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
      float d = inf_f();
      if (mask == nullptr || __ldg(mask + n)) {
        const uint8_t* row = codes + n * M;
        d = adc_row<W>(__ldg(reinterpret_cast<const CodeVec<W>*>(row)), row, tab, M, K);
      }
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

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int W>
cudaError_t launch_probed(const float* table, const int32_t* probe, const uint8_t* codes, const int32_t* slab_ids,
                          const uint8_t* mask, long long mask_len, int B, int p, int C, int S, int M, int K,
                          int rr, int chunk, float* out_d, int32_t* out_i, cudaStream_t stream) {
  const int cap = pow2_at_least(rr);
  const size_t smem = ((size_t)M * K + chunk + 4 * (size_t)cap) * 4;
  const cudaError_t e = smem_opt_in((const void*)pq_probe_scan_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  pq_probe_scan_kernel<W><<<B, kThreads, smem, stream>>>(table, probe, codes, slab_ids, mask, mask_len, p, C, S, M,
                                                           K, rr, chunk, cap, out_d, out_i);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dense(const float* table, const uint8_t* codes, const uint8_t* mask, int B, long long N, int M,
                         int K, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * 4;
  const cudaError_t e = smem_opt_in((const void*)pq_scan_dense_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (N + kThreads * kDenseRows - 1) / (kThreads * kDenseRows);
  pq_scan_dense_kernel<W><<<dim3(B, (unsigned)tiles), kThreads, smem, stream>>>(table, codes, mask, N, M, K, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers are device pointers; mask may be null (no filter). chunk is the
// slots a block scores between two selections: a multiple of 256. Returns
// the first CUDA error of the launch (0 on success). Launches on `stream`;
// does not synchronise.
int semadb_pq_probe_scan(const void* table, const void* probe, const void* slab_codes, const void* slab_ids,
                         const void* mask, long long mask_len, int B, int p, int C, int S, int M, int K, int rr,
                         int chunk, void* out_d, void* out_i, void* stream) {
  if (B <= 0 || p < 0 || C <= 0 || S <= 0 || M <= 0 || K <= 0 || K > kMaxK || rr <= 0 || rr > kMaxRr ||
      chunk < kThreads || chunk % kThreads != 0 || (long long)p * S > (1LL << 30) || (long long)C * S > INT_MAX) {
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
    case 16: return (int)launch_probed<16>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, chunk, od, oi, s);
    case 8: return (int)launch_probed<8>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, chunk, od, oi, s);
    case 4: return (int)launch_probed<4>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, chunk, od, oi, s);
    default: return (int)launch_probed<1>(t, pr, c, ids, mk, mask_len, B, p, C, S, M, K, rr, chunk, od, oi, s);
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
