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
//      whose id is not -1 (and is allowed by the mask), ascending by d, as
//      out_d f32[B, rr] and out_i i32[B, rr]; unfilled slots (inf, -1).
//   A cluster probed twice by one query counts twice, as in the JAX program;
//   probe entries outside [0, C) are skipped.
//
// What bounds it on the H100: bytes. Each probed slot costs r multiply-adds
// per query against r * 2-4 bytes of slab row, far below the card's ~20
// flops a byte for f32 outside the tensor cores. The least traffic reads each
// distinct probed cluster's ids once a batch, and the rows and norms of its
// live slots once. At the 1M x 128 bench cell a batch of 4,096 queries x 24
// probes falls on ~24,500 distinct clusters, ~4 queries each: reading a
// cluster once per query that probes it (one block per query, the first
// design) read 4.8x the bytes the function needs.
//
// So the design is cluster-major. It reads each probed cluster once per
// group of up to Q of the (query, probe) pairs that name it (Q = 16 at
// r <= 768; fewer past it, so the group's queries fit in 48 KB of shared
// memory), in five kernels and a memset:
//   1. ivf_scan_count   histogram of the probe list into counts[C] (atomics;
//                       the counts were zeroed by one memset of the work area);
//   2. ivf_scan_offsets one block: exclusive scan of counts into offsets[C]
//                       tile by tile (coalesced loads, a carried total), and
//                       the compacted list of work items (cluster, first pair,
//                       pairs), ceil(count / Q) per probed cluster, so a
//                       cluster that hundreds of queries probe becomes several
//                       items of Q pairs, and empty clusters cost nothing;
//   3. ivf_scan_invert  scatter of each pair (b * p + j) into its cluster's
//                       list (order inside a cluster is free: step 5 sorts); a
//                       pair whose probe lies outside [0, C) gets a row of inf
//                       scores instead;
//   4. ivf_scan_score   a persistent grid (as many blocks as fit on the SMs)
//                       that takes items from an atomic counter. A block's
//                       item is a chain of dependent loads (the item, then its
//                       pairs and the cluster's ids, then the queries and the
//                       rows), so the next item's index and record are loaded
//                       while this one runs, and the first rows are loaded
//                       before the block waits for its queries. NIL and masked
//                       slots never read their row. A team of lanes loads each
//                       live row once, kChunk 16-byte units a lane in flight
//                       before any is used (a 512-byte f32 row of r = 128 is 4
//                       lanes x 8 loads, 8 rows a warp), and scores it against
//                       every query of the item with f32 FFMA. The scores
//                       gather in shared memory and go out as one coalesced row
//                       of S per pair to scratch f32[B, p, S] (inf for dead
//                       slots). Exact: the top-rr over the union of every
//                       pair's slots is the query's;
//   5. ivf_scan_merge   one block of 128 threads per query reads its p * S
//                       scores twice (the second time from cache). First each
//                       thread takes the minimum of its share: the rr-th
//                       smallest of those distinct minima bounds the query's
//                       rr-th score from above, tightly (about the 3% point at
//                       the cell). Then the (score, slot) pairs up to the
//                       bound are appended in shared memory and sorted by a
//                       bitonic network once at the end (sooner, and cut to
//                       the running top-rr, only if the buffer could fill);
//                       8 KB a block at rr = 64, so many queries share an SM.
//                       Only the rr kept slots look up their ids.
// The scratch is B * p * S * 4 bytes (50 MB at the cell, written once and
// read once); the wrapper chunks B to keep it under its budget.
//
// Rows are scored by a team of ts lanes with 16-byte loads, or with element
// loads when the row is off the 16-byte grid (r = 3, or bf16 with r % 8 != 0);
// accumulation is f32; bf16 -> f32 is a bit shift; ragged r and S need no
// padding. Built with nvcc for sm_90a into a shared library with a plain C
// interface.

#include <type_traits>

#include "ivf_common.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int kMaxRr = 2048;       // the pool the merge keeps, at most
constexpr int kQmax = 16;          // (query, probe) pairs of one work item, at most
constexpr int kChunk = 8;          // units of a row a lane holds in flight
constexpr int kSlotTile = ivf::kThreads;  // slots of a cluster scored at once: one a thread
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 4;        // clusters a thread of ivf_scan_offsets takes
constexpr int kScanTile = kScanThreads * kScanPer;
constexpr int kQBytes = 48 * 1024;  // shared memory for a work item's queries
constexpr int kMergeThreads = 128;  // a query's block in the merge
constexpr int kMergeUnroll = 4;
constexpr int kQLoads = 4;
constexpr unsigned kFullMask = 0xffffffffu;

using ivf::inf_f;
using ivf::keep_top;
using ivf::warp_append;

// Pairs of one work item: as many queries of r floats as kQBytes holds, 1..kQmax.
__host__ __device__ inline int group_size(int r) {
  const int q = kQBytes / (((r + 7) & ~7) * 4);
  return q < 1 ? 1 : (q > kQmax ? kQmax : q);
}

__global__ void ivf_scan_count(const int32_t* __restrict__ probe, long long n, int C, int* __restrict__ counts) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const int c = __ldg(probe + t);
    if (c >= 0 && c < C) atomicAdd(counts + c, 1);
  }
}

// Exclusive scan of two ints over the block (blockDim.x a multiple of 32);
// also returns both totals.
__device__ void block_scan2(int a, int b, int* a_ex, int* b_ex, int* a_tot, int* b_tot) {
  __shared__ int wa[32], wb[32], ta, tb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int ia = a, ib = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFullMask, ia, off), y = __shfl_up_sync(kFullMask, ib, off);
    if (lane >= off) {
      ia += x;
      ib += y;
    }
  }
  if (lane == 31) {
    wa[warp] = ia;
    wb[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    const int x = lane < nw ? wa[lane] : 0, y = lane < nw ? wb[lane] : 0;
    int ix = x, iy = y;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFullMask, ix, off), v = __shfl_up_sync(kFullMask, iy, off);
      if (lane >= off) {
        ix += u;
        iy += v;
      }
    }
    if (lane < nw) {
      wa[lane] = ix - x;
      wb[lane] = iy - y;
    }
    if (lane == 31) {
      ta = ix;
      tb = iy;
    }
  }
  __syncthreads();
  *a_ex = wa[warp] + ia - a;
  *b_ex = wb[warp] + ib - b;
  *a_tot = ta;
  *b_tot = tb;
}

// header[0]: the score kernel's item counter; header[1]: the number of items;
// header[2]: the tile counter. One block a tile of kScanTile clusters (thread
// t takes kScanPer consecutive ones: coalesced loads, all in flight at once).
// A single-pass scan with decoupled look-back: a block publishes its tile's
// totals, then adds its predecessors' (stopping at the first that published
// an inclusive prefix) and publishes its own prefix. Tiles are numbered in
// the order blocks start, so every block waits only on running ones.
constexpr unsigned long long kAggregate = 1ull << 62, kPrefix = 2ull << 62;

__device__ __forceinline__ unsigned long long pack(unsigned long long flag, int n, int w) {
  return flag | ((unsigned long long)n << 31) | (unsigned long long)w;
}

__global__ void __launch_bounds__(kScanThreads)
ivf_scan_offsets(int* __restrict__ counts, int C, int Q, int* __restrict__ offsets,
                 int4* __restrict__ items, int* __restrict__ header, unsigned long long* status) {
  __shared__ int s_tile, s_n_before, s_w_before;
  if (threadIdx.x == 0) s_tile = atomicAdd(header + 2, 1);
  __syncthreads();
  const int tile = s_tile;
  const int c0 = tile * kScanTile + (int)threadIdx.x * kScanPer;
  int k[kScanPer];
  int n = 0, w = 0;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    k[i] = c0 + i < C ? counts[c0 + i] : 0;
    n += k[i];
    w += (k[i] + Q - 1) / Q;
  }
  int n_ex, w_ex, n_tot, w_tot;
  block_scan2(n, w, &n_ex, &w_ex, &n_tot, &w_tot);
  if (threadIdx.x == 0) {
    int n_before = 0, w_before = 0;
    if (tile > 0) {
      atomicExch(status + tile, pack(kAggregate, n_tot, w_tot));
      for (int j = tile - 1; j >= 0;) {
        const unsigned long long st = *reinterpret_cast<volatile unsigned long long*>(status + j);
        if (st == 0) continue;  // not published yet
        n_before += (int)((st >> 31) & 0x7fffffff);
        w_before += (int)(st & 0x7fffffff);
        if ((st & kPrefix) != 0) break;
        --j;
      }
    }
    atomicExch(status + tile, pack(kPrefix, n_before + n_tot, w_before + w_tot));
    s_n_before = n_before;
    s_w_before = w_before;
    if (tile == (int)gridDim.x - 1) header[1] = w_before + w_tot;
  }
  __syncthreads();
  n_ex += s_n_before;
  w_ex += s_w_before;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    if (c0 + i < C) {
      offsets[c0 + i] = n_ex;
      for (int j = 0; j < k[i]; j += Q) items[w_ex++] = make_int4(c0 + i, n_ex + j, min(Q, k[i] - j), 0);
      n_ex += k[i];
      counts[c0 + i] = 0;  // from here on, ivf_scan_invert's cursor
    }
  }
}

__global__ void ivf_scan_invert(const int32_t* __restrict__ probe, long long n, int C, int S,
                                const int* __restrict__ offsets, int* __restrict__ cursor,
                                int* __restrict__ pairs, float* __restrict__ scratch) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const int c = __ldg(probe + t);
    if (c >= 0 && c < C) {
      pairs[offsets[c] + atomicAdd(cursor + c, 1)] = (int)t;
    } else {
      for (int s = 0; s < S; ++s) scratch[t * S + s] = inf_f();
    }
  }
}

// One unit of a row (16 bytes, or one element off the 16-byte grid).
template <bool kVec, bool kBf16>
struct Unit {
  using T = typename std::conditional<kVec, uint4, float>::type;
  static __device__ __forceinline__ T load(const unsigned char* row, int u) {
    if constexpr (kVec) {
      return __ldg(reinterpret_cast<const uint4*>(row) + u);
    } else if constexpr (kBf16) {
      return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const uint16_t*>(row) + u) << 16);
    } else {
      return __ldg(reinterpret_cast<const float*>(row) + u);
    }
  }
  static __device__ __forceinline__ T zero() {
    if constexpr (kVec) {
      return make_uint4(0, 0, 0, 0);
    } else {
      return 0.f;
    }
  }
  // <unit u of the row, the matching elements of q>
  static __device__ __forceinline__ float dot(T v, const float* q, int u) {
    if constexpr (kVec && kBf16) {
      const float4 a = reinterpret_cast<const float4*>(q)[2 * u];
      const float4 b = reinterpret_cast<const float4*>(q)[2 * u + 1];
      float acc = ivf::bf16_lo(v.x) * a.x;
      acc = fmaf(ivf::bf16_hi(v.x), a.y, acc);
      acc = fmaf(ivf::bf16_lo(v.y), a.z, acc);
      acc = fmaf(ivf::bf16_hi(v.y), a.w, acc);
      acc = fmaf(ivf::bf16_lo(v.z), b.x, acc);
      acc = fmaf(ivf::bf16_hi(v.z), b.y, acc);
      acc = fmaf(ivf::bf16_lo(v.w), b.z, acc);
      return fmaf(ivf::bf16_hi(v.w), b.w, acc);
    } else if constexpr (kVec) {
      const float4 a = reinterpret_cast<const float4*>(q)[u];
      float acc = __uint_as_float(v.x) * a.x;
      acc = fmaf(__uint_as_float(v.y), a.y, acc);
      acc = fmaf(__uint_as_float(v.z), a.z, acc);
      return fmaf(__uint_as_float(v.w), a.w, acc);
    } else {
      return v * q[u];
    }
  }
};

// The first tile of an item's cluster (one slot a thread: its id and norm)
// and its pairs (threads < pairs), loaded into registers one item ahead.
struct Ahead {
  int id, pair;
  float sq;
};

__device__ __forceinline__ Ahead load_ahead(int4 it, const int32_t* __restrict__ slab_ids,
                                            const float* __restrict__ slab_sq, const int* __restrict__ pairs,
                                            int S) {
  Ahead a{-1, 0, 0.f};
  if (it.x >= 0) {
    const long long cell = (long long)it.x * S + threadIdx.x;
    if ((int)threadIdx.x < S) {
      a.id = __ldg(slab_ids + cell);
      a.sq = __ldg(slab_sq + cell);
    }
    if ((int)threadIdx.x < it.z) a.pair = __ldg(pairs + it.y + threadIdx.x);
  }
  return a;
}

// kWide: a row is more than one chunk of ts * kChunk units (r > 1024 f32 on
// the 16-byte path), so per-query sums are carried across chunks in
// registers; otherwise each query's sum is reduced as soon as its chunk is.
// At most 85 registers (80 allocated), so three blocks share an SM (two for
// bf16 rows on the 16-byte path, which unpack each unit into eight floats).
template <bool kVec, bool kBf16, bool kWide>
__global__ void __launch_bounds__(ivf::kThreads, (kVec && kBf16) ? 2 : 3)
ivf_scan_score(const float* __restrict__ qp, int p, const void* __restrict__ slabs,
               const float* __restrict__ slab_sq, const int32_t* __restrict__ slab_ids,
               const uint8_t* __restrict__ mask, long long mask_len, int S, int r, int Q,
               const int4* __restrict__ items, const int* __restrict__ pairs, int* __restrict__ header,
               float* __restrict__ scratch) {
  using U = Unit<kVec, kBf16>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rpad = (r + 7) & ~7;
  float* qs = reinterpret_cast<float*>(smem);                      // [Q][rpad] the item's queries
  float* sc = qs + (size_t)Q * rpad;                               // [Q][kSlotTile] their scores
  int* live = reinterpret_cast<int*>(sc + (size_t)Q * kSlotTile);  // [kSlotTile] live slots
  float* live_sq = reinterpret_cast<float*>(live + kSlotTile);     // [kSlotTile] their norms
  __shared__ int4 s_first, s_next;    // (cluster, first pair, pairs), or cluster -1: none
  __shared__ int s_nlive;
  __shared__ long long s_out[kQmax];  // scratch offset of each pair's row of S scores
  __shared__ int s_query[kQmax];      // each pair's query

  const size_t elem = kBf16 ? 2 : 4;
  const int units = kVec ? (int)(r * elem / 16) : r;
  const int ts = ivf::team_size((units + kChunk - 1) / kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tl = lane & (ts - 1), team = lane / ts;
  const int teams_per_warp = 32 / ts;
  const int rows_per_pass = ivf::kWarps * teams_per_warp;
  const int n_items = header[1];
  const int4 none = make_int4(-1, 0, 0, 0);

  // An item is a chain of dependent loads (its record, then its pairs and
  // ids, then its queries and rows). The block runs it two items deep: while
  // item i runs, item i + 1's record is known and its pairs, ids and norms
  // are loading, and thread 0 takes item i + 2's index and record.
  if (threadIdx.x == 0) {
    const int w0 = atomicAdd(header, 1);
    s_first = w0 < n_items ? items[w0] : none;
    const int w1 = atomicAdd(header, 1);
    s_next = w1 < n_items ? items[w1] : none;
    s_nlive = 0;
  }
  __syncthreads();
  int4 it = s_first;
  Ahead ahead = load_ahead(it, slab_ids, slab_sq, pairs, S);
  while (it.x >= 0) {
    const int4 nx = s_next;
    int after = n_items;
    int4 after_item = none;
    if (threadIdx.x == 0) after = atomicAdd(header, 1);
    const int c = it.x, nq = it.z;
    if ((int)threadIdx.x < nq) {
      s_out[threadIdx.x] = (long long)ahead.pair * S;
      s_query[threadIdx.x] = ahead.pair / p;
    }
    const long long cell0 = (long long)c * S;
    const unsigned char* rows = static_cast<const unsigned char*>(slabs) + cell0 * r * elem;
    for (int t0 = 0; t0 < S; t0 += kSlotTile) {
      const int tn = min(S - t0, kSlotTile);
      for (int e = threadIdx.x; e < nq * kSlotTile; e += blockDim.x) sc[e] = inf_f();
      // List the live slots of this tile (NIL and masked slots keep inf)
      const int x = threadIdx.x;
      int id = -1;
      float sq = 0.f;
      if (t0 == 0) {
        id = ahead.id;
        sq = ahead.sq;
      } else if (x < tn) {
        id = __ldg(slab_ids + cell0 + t0 + x);
        sq = __ldg(slab_sq + cell0 + t0 + x);
      }
      const bool ok = x < tn && id != -1 && (mask == nullptr || (id >= 0 && id < mask_len && __ldg(mask + id)));
      const unsigned m = __ballot_sync(kFullMask, ok);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(&s_nlive, __popc(m));
      base = __shfl_sync(kFullMask, base, 0);
      if (ok) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        live[pos] = x;
        live_sq[pos] = sq;
      }
      __syncthreads();  // the live list, s_out and s_query are set
      const int nlive = s_nlive;
      // The first pass's rows are loaded before the queries, so both are in
      // flight together
      typename U::T v[kChunk];
      {
        const int li = warp * teams_per_warp + team;
        const unsigned char* row = rows + (size_t)(t0 + (li < nlive ? live[li] : 0)) * r * elem;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int u = i * ts + tl;
          v[i] = li < nlive && u < units ? U::load(row, u) : U::zero();
        }
      }
      if (t0 == 0) {
        // kQLoads loads of a thread in flight before their stores
        for (int e0 = 0; e0 < nq * rpad; e0 += kQLoads * blockDim.x) {
          float val[kQLoads];
#pragma unroll
          for (int i = 0; i < kQLoads; ++i) {
            const int e = e0 + i * blockDim.x + threadIdx.x, k = e / rpad, xx = e - k * rpad;
            val[i] = e < nq * rpad && xx < r ? __ldg(qp + (long long)s_query[k] * r + xx) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kQLoads; ++i) {
            const int e = e0 + i * blockDim.x + threadIdx.x;
            if (e < nq * rpad) qs[e] = val[i];
          }
        }
        if (threadIdx.x == 0 && after < n_items) after_item = items[after];
        ahead = load_ahead(nx, slab_ids, slab_sq, pairs, S);
      }
      __syncthreads();  // the queries are set; every thread has read s_nlive
      if (threadIdx.x == 0) s_nlive = 0;
      for (int b0 = warp * teams_per_warp; b0 < nlive; b0 += rows_per_pass) {
        const int li = b0 + team;
        const bool have = li < nlive;
        const int xs = have ? live[li] : 0;
        const unsigned char* row = rows + (size_t)(t0 + xs) * r * elem;
        if (b0 != warp * teams_per_warp) {
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            const int u = i * ts + tl;
            v[i] = have && u < units ? U::load(row, u) : U::zero();
          }
        }
        if constexpr (kWide) {
          float acc[kQmax];
#pragma unroll
          for (int k = 0; k < kQmax; ++k) acc[k] = 0.f;
          for (int u0 = 0;;) {
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
              const int u = u0 + i * ts + tl;
              if (u < units) {
#pragma unroll
                for (int k = 0; k < kQmax; ++k) {
                  if (k < nq) acc[k] += U::dot(v[i], qs + k * rpad, u);
                }
              }
            }
            u0 += ts * kChunk;
            if (u0 >= units) break;
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
              const int u = u0 + i * ts + tl;
              v[i] = have && u < units ? U::load(row, u) : U::zero();
            }
          }
#pragma unroll
          for (int k = 0; k < kQmax; ++k) {
            if (k < nq) {
              const float dot = ivf::team_sum(acc[k], ts);
              if (have && tl == 0) sc[k * kSlotTile + xs] = live_sq[li] - 2.f * dot;
            }
          }
        } else {
          for (int k = 0; k < nq; ++k) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
              const int u = i * ts + tl;
              if (u < units) part += U::dot(v[i], qs + k * rpad, u);
            }
            const float dot = ivf::team_sum(part, ts);
            if (have && tl == 0) sc[k * kSlotTile + xs] = live_sq[li] - 2.f * dot;
          }
        }
      }
      __syncthreads();  // the tile's scores are complete
      // Each pair's scores of this tile, written out in order
      for (int e = threadIdx.x; e < nq * tn; e += blockDim.x) {
        const int k = e / tn, xx = e - k * tn;
        scratch[s_out[k] + t0 + xx] = sc[k * kSlotTile + xx];
      }
      __syncthreads();  // sc and live are free for the next tile or item
    }
    if (threadIdx.x == 0) s_next = after < n_items ? after_item : none;
    __syncthreads();
    it = nx;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
ivf_scan_merge(const float* __restrict__ scratch, const int32_t* __restrict__ probe,
               const int32_t* __restrict__ slab_ids, int p, int S, int rr, int nbuf,
               float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bd = reinterpret_cast<float*>(smem);   // [nbuf]
  int* bi = reinterpret_cast<int*>(bd + nbuf);  // [nbuf] the slot: j * S + s of the query's flat list
  __shared__ int count, kept;
  __shared__ float thresh;
  const long long b = blockIdx.x;
  const long long total = (long long)p * S;
  const float* mine = scratch + b * total;
  const int step = kMergeUnroll * blockDim.x;
  // Each thread's minimum over its share of the scores: they are distinct
  // elements, so the rr-th smallest of the kMergeThreads minima bounds the
  // query's rr-th score from above (about the 3% point at the cell), and only
  // the scores up to it are appended and sorted
  float least = inf_f();
  for (long long base = 0; base < total; base += step) {
#pragma unroll
    for (int i = 0; i < kMergeUnroll; ++i) {
      const long long t = base + i * blockDim.x + threadIdx.x;
      if (t < total) least = fminf(least, __ldg(mine + t));
    }
  }
  bd[threadIdx.x] = least;
  bi[threadIdx.x] = threadIdx.x;
  __syncthreads();
  ivf::bitonic_sort(bd, bi, kMergeThreads);
  if (threadIdx.x == 0) {
    count = 0;
    kept = 0;
    thresh = rr <= kMergeThreads ? bd[rr - 1] : inf_f();
  }
  __syncthreads();
  // One pass over the scores; the appended pairs are cut to the running
  // top-rr only when the next step's appends might not fit (never at the
  // cell, where about 70 pass the bound)
  float th = thresh;
  for (long long base = 0; base < total; base += step) {
    th = ivf::make_room(bd, bi, rr, step, nbuf, &count, &kept, &thresh, th);
    float d[kMergeUnroll];
#pragma unroll
    for (int i = 0; i < kMergeUnroll; ++i) {
      const long long t = base + i * blockDim.x + threadIdx.x;
      d[i] = t < total ? __ldcs(mine + t) : inf_f();
    }
#pragma unroll
    for (int i = 0; i < kMergeUnroll; ++i) {
      warp_append(d[i] <= th && d[i] < inf_f(), d[i], (int)(base + i * blockDim.x + threadIdx.x), &count, bd, bi);
    }
    __syncthreads();
  }
  keep_top(bd, bi, rr, &count, &kept, &thresh);
  for (int i = threadIdx.x; i < rr; i += blockDim.x) {
    float d = inf_f();
    int id = -1;
    if (i < kept) {
      const int t = bi[i], j = t / S;
      d = bd[i];
      id = __ldg(slab_ids + (long long)__ldg(probe + b * p + j) * S + (t - j * S));
    }
    out_d[b * rr + i] = d;
    out_i[b * rr + i] = id;
  }
}

// The work area, in ints: header[4] | counts[C] | pad | status[tiles] (one
// 64-bit word a tile of ivf_scan_offsets) | pad | items[4 * max_items] |
// offsets[C] | pairs[B * p]. Only header, counts and status are zeroed.
struct Work {
  long long status_at, zeroed, items_at, offsets_at, pairs_at, total;
};

inline long long max_items(int B, int p, int C, int r) {
  const long long n = (long long)B * p;
  return (C < n ? C : n) + n / group_size(r);
}

inline int scan_tiles(int C) { return (C + kScanTile - 1) / kScanTile; }

inline Work work_layout(int B, int p, int C, int r) {
  Work w;
  w.status_at = (4 + (long long)C + 1) & ~1LL;
  w.zeroed = w.status_at + 2LL * scan_tiles(C);
  w.items_at = (w.zeroed + 3) & ~3LL;
  w.offsets_at = w.items_at + 4 * max_items(B, p, C, r);
  w.pairs_at = w.offsets_at + C;
  w.total = w.pairs_at + (long long)B * p;
  return w;
}

inline int grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 132 * 8 ? (blocks > 0 ? blocks : 1) : 132 * 8);
}

struct Operands {
  const float* qp;
  const int32_t* probe;
  const void* slabs;
  const float* slab_sq;
  const int32_t* slab_ids;
  const uint8_t* mask;
  long long mask_len;
  int B, p, C, S, r, rr;
  float* out_d;
  int32_t* out_i;
};

template <bool kVec, bool kBf16, bool kWide>
cudaError_t launch_score(const Operands& o, int Q, const int4* items, const int* pairs, int* header,
                         float* scratch, cudaStream_t stream) {
  const size_t smem = ((size_t)Q * (((o.r + 7) & ~7) + kSlotTile) + 2 * kSlotTile) * 4;
  cudaError_t e = smem_opt_in((const void*)ivf_scan_score<kVec, kBf16, kWide>, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ivf_scan_score<kVec, kBf16, kWide>, ivf::kThreads,
                                                         smem)) != cudaSuccess) {
    return e;
  }
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long most = max_items(o.B, o.p, o.C, o.r);
  if (grid > most) grid = most;
  ivf_scan_score<kVec, kBf16, kWide><<<(int)grid, ivf::kThreads, smem, stream>>>(
      o.qp, o.p, o.slabs, o.slab_sq, o.slab_ids, o.mask, o.mask_len, o.S, o.r, Q, items, pairs, header, scratch);
  return cudaGetLastError();
}

template <bool kVec, bool kBf16>
cudaError_t launch(const Operands& o, int* work, float* scratch, cudaStream_t stream) {
  const Work w = work_layout(o.B, o.p, o.C, o.r);
  const int Q = group_size(o.r);
  const long long n = (long long)o.B * o.p;
  int* header = work;
  int* counts = work + 4;
  int4* items = reinterpret_cast<int4*>(work + w.items_at);
  int* offsets = work + w.offsets_at;
  int* pairs = work + w.pairs_at;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(work + w.status_at);
  cudaError_t e = cudaMemsetAsync(work, 0, (size_t)w.zeroed * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  ivf_scan_count<<<grid_for(n, 256), 256, 0, stream>>>(o.probe, n, o.C, counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ivf_scan_offsets<<<scan_tiles(o.C), kScanThreads, 0, stream>>>(counts, o.C, Q, offsets, items, header, status);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ivf_scan_invert<<<grid_for(n, 256), 256, 0, stream>>>(o.probe, n, o.C, o.S, offsets, counts, pairs, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int units = kVec ? o.r * (kBf16 ? 2 : 4) / 16 : o.r;
  e = (units + kChunk - 1) / kChunk > 32 ? launch_score<kVec, kBf16, true>(o, Q, items, pairs, header, scratch, stream)
                                         : launch_score<kVec, kBf16, false>(o, Q, items, pairs, header, scratch, stream);
  if (e != cudaSuccess) return e;
  int nbuf = 1024;  // candidate pairs: a power of two with room for rr kept and a step's appends
  while (nbuf < o.rr + kMergeUnroll * kMergeThreads) nbuf <<= 1;
  const size_t msmem = (size_t)nbuf * 8;
  if ((e = smem_opt_in((const void*)ivf_scan_merge, msmem)) != cudaSuccess) return e;
  ivf_scan_merge<<<o.B, kMergeThreads, msmem, stream>>>(scratch, o.probe, o.slab_ids, o.p, o.S, o.rr, nbuf,
                                                         o.out_d, o.out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of the work area for B queries of p probes over C clusters at width r
// (the wrapper allocates it, and the scratch of B * p * S floats).
long long semadb_ivf_scan_work_ints(int B, int p, int C, int r) { return work_layout(B, p, C, r).total; }

// Pointers are device pointers; mask may be null (no filter). bf16 != 0
// means slabs hold bf16, else f32. `work` holds semadb_ivf_scan_work_ints
// ints, `scratch` B * p * S floats. Returns the first CUDA error of the
// launches (0 on success). Launches on `stream`; does not synchronise.
int semadb_ivf_probe_scan(const void* qp, const void* probe, const void* slabs,
                          const void* slab_sq, const void* slab_ids, const void* mask,
                          long long mask_len, int B, int p, int C, int S, int r, int bf16, int rr,
                          void* work, void* scratch, void* out_d, void* out_i, void* stream) {
  if (B <= 0 || p <= 0 || C <= 0 || S <= 0 || r <= 0 || r > 4096 || rr <= 0 || rr > kMaxRr ||
      work == nullptr || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elem = bf16 ? 2 : 4;
  const bool vec = (r * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(slabs) % 16 == 0;
  const Operands o{static_cast<const float*>(qp), static_cast<const int32_t*>(probe), slabs,
                   static_cast<const float*>(slab_sq), static_cast<const int32_t*>(slab_ids),
                   static_cast<const uint8_t*>(mask), mask_len, B, p, C, S, r, rr,
                   static_cast<float*>(out_d), static_cast<int32_t*>(out_i)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(work);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t e = bf16 ? (vec ? launch<true, true>(o, w, sc, s) : launch<false, true>(o, w, sc, s))
                             : (vec ? launch<true, false>(o, w, sc, s) : launch<false, false>(o, w, sc, s));
  return (int)e;
}

const char* semadb_ivf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
