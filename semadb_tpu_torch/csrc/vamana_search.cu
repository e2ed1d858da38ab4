// K10: the Vamana beam search, the whole walk in one launch, for Hopper.
//
// Replaces the XLA program of semadb_tpu/index/vamana/search.py · beam_search
// (:123-246): a lax.while_loop of hops over a batch of queries, each hop
// taking the W earliest unexpanded entries of the sorted candidate list,
// gathering their adjacency rows, scoring the W*R neighbours
// (ops/distance.py:96-123 gather_distance) and merging them into the list
// (_merge_sorted :76-113).
//
//   vectors f32[cap, D] x adjacency i32[cap, R] x queries f32[B, D]
//   (x seeds i32[B, S]) -> the candidate list (cand_d f32, cand_i i32)[B, L],
//      the visited ring (vis_d f32, vis_i i32)[B, V] sorted by (d, id),
//      V = ceil(2L/W)*W, the hops each query took i32[B] and its counts
//      i32[B, 2]: nodes expanded, neighbour rows scored
//
// Semantics, as the JAX program's:
//   - the list starts as (d(start), START_ID) and L-1 empty slots
//     (inf, -1); seeds (neither -1 nor START_ID) are merged in first, with
//     compaction;
//   - a hop selects the W earliest list positions whose entry is unexpanded,
//     not -1 and finite; marks them expanded; with track_visited writes them
//     at ring slots (hop mod V/W)*W + w; scores every non-NIL neighbour of
//     each (its row index clipped to [0, cap)); then merges: the list and the
//     W*R new entries (unselected rows' entries empty) sorted by (d, id), the
//     list's entry first among equal keys (jax.lax.sort is stable over the
//     concatenation), so an incumbent keeps its expanded flag; each entry
//     whose id equals its predecessor's (and is not -1) becomes (inf, -1);
//     with compaction the result is sorted again; the first L are the list.
//     The hops compact exactly when track_visited is on, as the JAX program
//     does by default (compact_merge follows track_visited);
//   - the JAX loop runs while ANY query of the batch has a pending entry and
//     hop < max_hops. A query with nothing pending does not change under a
//     step, except that an uncompacted list's holes move to its tail; so each
//     query here stops on its own and its result is the batch loop's up to
//     the place of those holes (tests/test_torch_vamana.py holds this);
//   - metrics as gather_distance: euclidean sum (c - q)^2 taken directly (not
//     the norm expansion), dot -sum c q, cosine 1 - sum c q, haversine the
//     meters of _haversine_pair with each product and sum rounded as PyTorch's
//     elementwise kernels round them (no contraction into FMAs).
//
// Scoring routes (the JAX _make_gd, search.py:47-65), one template instance
// of the same walk each; the list, the ring, the merge and the (d, id) keys
// are the same code for all three:
//   - f32: the rows above (semadb_vamana_beam_search);
//   - bit: packed codes i32[cap, W] against the query's code i32[W]
//     (gather_bit_distance, ops/distance.py:154-171): hamming the popcount
//     of the xor, jaccard 1 - inter / union by one IEEE division, 0 where
//     union == 0. A lane scores a row, at W = 4 (D = 128) in one 16-byte
//     load, so a warp has 32 rows in flight where the f32 route has 8; the
//     query's first 4 words sit in registers;
//   - ADC: PQ codes u8[cap, M] through the query's table f32[M, K]
//     (pq_gather_distance, vectorstore/store.py:316-326), the M terms summed
//     in the order 0..M-1; a lane scores a row, 8 codes a load. The table is
//     staged in shared memory once a walk when it holds at most
//     kAdcStageBytes (32 KB: M = 32 at K = 256), else read through L2 (e.g.
//     D = 1536, M = 96): a route chosen by size.
// (semadb_vamana_beam_search_codes.) Quantized distances tie constantly
// across ids; the (d, id) key orders them, as the JAX program's 2-key sort.
//
// What bounds it on the H100: bytes. A hop reads W adjacency rows (4 R bytes
// each) and scores up to W*R rows of 4 D bytes with D multiply-adds each,
// about 0.5 operations a byte, far below the card's ratio. The least traffic
// is each distinct row that the batch's walks score, and each distinct
// adjacency row they read, once for the whole batch ((distinct rows scored x D
// + distinct nodes expanded x R) x 4 bytes, plus the queries and outputs) over
// 3.35 TB/s (tools/vamana_operands.py k10_least_bytes). The walks of one batch
// share many rows, so the kernel, which reads a row for every time it scores
// it, moves several times that through L2.
//
// What the design does about it (the second design; the first, one block of
// 256 threads a query with a bitonic sort of the whole padded buffer each
// merge, ran at 2.3% of the bound):
//   1. Geometry by shape. A team of NW warps serves one query and holds its
//      query, list, survivors and ring in shared memory for the whole walk.
//      Where a hop brings at most 128 new entries (the query walk: W = 2,
//      R = 64) a query takes one warp and a block holds kWarpQueries of them,
//      six blocks an SM (80 registers a thread; more warps with fewer
//      registers spill and measured slower), so some 3,200 queries walk at
//      once and a hop's steps are __syncwarp apart; where it brings more (the
//      build's W = 8) a query takes a block of 4 or 8 warps (8 when the batch
//      is small, so that the card's few queries have more rows in flight).
//      pick_geometry below is the rule, the only copy of it; the card tests
//      (tests/test_torch_cuda.py) launch every shape they check, so a shape
//      whose block does not fit fails there.
//   2. Rows in flight. A team of 8 lanes scores a row with 16-byte loads
//      (at D = 128 a lane loads 4 float4 of it), and each lane issues the
//      loads of kRowsInFlight rows before its first add. Not reading again a
//      row already in the list, reusing its incumbent's key, gives the same
//      holes bit for bit, but the search of the list for each new id cost
//      more than the reads it saved at every shape measured (PERF.md): it
//      is left out.
//   3. A merge that sorts only what can enter. An entry's key is one u64,
//      (distance's order bits, id + 1, -0.0 flag), holes (inf, -1); -0.0
//      and 0.0 share the order bits. A new entry can reach the first L only
//      if its key is below the list's largest key T (a hole counts as
//      (inf, -1)), since every list entry precedes it otherwise; with
//      compaction and a real entry at inf in the list every new entry is
//      kept, as its dups' holes would move ahead of that entry. The
//      survivors alone are sorted (a bitonic network over the next power of
//      two, a few dozen once the list is full), and every entry's place
//      follows from ranks (merge path): a list entry's place is its rank
//      among the list's real entries plus the survivors below it, a
//      survivor's its rank plus the list entries at or below it, and holes
//      form one block at (inf, -1). A survivor equal to its predecessor is a
//      dup: it becomes a hole in place, or with compaction the entries after
//      it move up over it and its hole joins the block. Without compaction
//      (the query walk) nearly every list holds such holes, so its largest
//      key is (inf, -1) and would keep every finite new entry: there only as
//      many new entries past the list's largest real key as can take a
//      hole's place are kept (hole_cut). This is the model
//      tests/test_torch_vamana_models.py holds equal to merge_sorted
//      (k10_merge_model).
// Distances stay f32 (no bf16, no TF32). The order of a row's sum is the
// team's: each lane sums its own elements, then the 8 lanes' partials. The
// bound of the quantized routes is the same count with a code row's bytes
// (16 at D = 128, M at ADC) in place of 4 D, and the queries' codes or
// tables in place of the queries.
// L <= 512, W * R <= 512, W <= L, L + S <= 2048, D <= 4096, ids in
// [-1, 2^31 - 2].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_optin.cuh"
#include "vamana_common.cuh"


namespace {

using namespace vamana;
using u64 = unsigned long long;

constexpr int kStartId = 1;
constexpr int kTeam = 8;           // lanes that score one row
constexpr int kRowsInFlight = 2;   // rows a lane loads before its first add (1 and 4 measured slower)
constexpr int kWarpMinBlocks = 6;  // blocks an SM the one-warp geometry takes: 80 registers a thread
constexpr int kWarpQueries = 4;    // queries a block holds in the one-warp geometry
constexpr int kWarpMaxNew = 128;   // new entries a hop may bring for one warp a query
constexpr int kSmallBatch = 1024;  // at or below, a block of 8 warps a query, else 4
constexpr int kMaxL = 512;
constexpr int kMaxWR = 512;
constexpr int kMaxM = 2048;
constexpr int kMaxD = 4096;
constexpr long long kSmemBudget = 232448;  // an H100 block's dynamic shared memory
constexpr long long kAdcStageBytes = 32768;  // the largest ADC table staged in shared memory (m = 32 at k = 256)
constexpr u64 kHole = 0xFF80000000000000ull;  // the key of (inf, -1)
constexpr u64 kPad = ~0ull;                    // sorts after every key

// The key of (d, id): d's order bits (-0.0 as 0.0), then id + 1, then a bit
// that remembers -0.0, so that equal distances fall to the id as in the
// stable (d, id) sort and the output keeps d's bits.
__device__ __forceinline__ u64 key_of(float d, int id) {
  unsigned u = __float_as_uint(d);
  const unsigned neg0 = u == 0x80000000u;
  if (neg0) u = 0u;
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)o << 32) | ((unsigned)(id + 1) << 1) | neg0;
}

__device__ __forceinline__ float dist_of(u64 k) {
  if (k & 1ull) return -0.0f;
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ int id_of(u64 k) { return (int)((unsigned)k >> 1) - 1; }

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// The threads that serve one query: NW warps.
template <int NW>
struct Team {
  static constexpr int kThreads = NW * 32;
  int tid, lane, warp;
  __device__ __forceinline__ void sync() const {
    if (NW == 1) __syncwarp();
    else __syncthreads();
  }
};

// Exclusive prefix of `pred` over the team's threads, in thread order; the
// count goes to `total` (every thread gets it).
template <int NW>
__device__ __forceinline__ int team_scan(bool pred, int* wsum, int& total, const Team<NW>& t) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  const int pre = __popc(m & lanes_below(t.lane));
  if (NW == 1) {
    total = __popc(m);
    return pre;
  }
  if (t.lane == 0) wsum[t.warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = wsum[w];
    before += w < t.warp ? c : 0;
    all += c;
  }
  __syncthreads();
  total = all;
  return before + pre;
}

template <int NW>
__device__ __forceinline__ u64 team_max(u64 v, u64* wmax, const Team<NW>& t) {
  const unsigned hi = (unsigned)(v >> 32);
  const unsigned hm = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lm = __reduce_max_sync(0xffffffffu, hi == hm ? (unsigned)v : 0u);
  const u64 r = ((u64)hm << 32) | lm;
  if (NW == 1) return r;
  if (t.lane == 0) wmax[t.warp] = r;
  __syncthreads();
  u64 all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) all = wmax[w] > all ? wmax[w] : all;
  __syncthreads();
  return all;
}

template <int NW>
__device__ __forceinline__ u64 team_min(u64 v, u64* wmin, const Team<NW>& t) {
  const unsigned hi = (unsigned)(v >> 32);
  const unsigned hm = __reduce_min_sync(0xffffffffu, hi);
  const unsigned lm = __reduce_min_sync(0xffffffffu, hi == hm ? (unsigned)v : 0xffffffffu);
  const u64 r = ((u64)hm << 32) | lm;
  if (NW == 1) return r;
  if (t.lane == 0) wmin[t.warp] = r;
  __syncthreads();
  u64 all = kPad;
#pragma unroll
  for (int w = 0; w < NW; ++w) all = wmin[w] < all ? wmin[w] : all;
  __syncthreads();
  return all;
}

template <int NW>
__device__ __forceinline__ int team_add(int v, int* wsum, const Team<NW>& t) {
  v = __reduce_add_sync(0xffffffffu, v);
  if (NW == 1) return v;
  if (t.lane == 0) wsum[t.warp] = v;
  __syncthreads();
  int all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) all += wsum[w];
  __syncthreads();
  return all;
}

// Bitonic sort of a[0, n) ascending, n a power of two (padding kPad);
// a[] must be visible to the team when it is called; ends with a sync.
template <int NW>
__device__ void team_sort(u64* a, int n, const Team<NW>& t) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int sh = __ffs(j) - 1;
      for (int s = t.tid; s < (n >> 1); s += Team<NW>::kThreads) {
        const int i = ((s >> sh) << (sh + 1)) + (s & (j - 1));
        const int l = i + j;
        const u64 x = a[i], y = a[l];
        if ((x > y) == ((i & k) == 0)) {
          a[i] = y;
          a[l] = x;
        }
      }
      t.sync();
    }
  }
}

__device__ __forceinline__ int count_below(const u64* a, int n, u64 x) {  // # a[i] < x
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_at_or_below(const u64* a, int n, u64 x) {  // # a[i] <= x
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ---- Scoring: one device function a metric. A team of kTeam lanes scores
// U rows at once; lane tl sums its elements, the team adds the partials.
// Rows with ok false contribute nothing and load nothing.

__device__ __forceinline__ float team_sum(float acc) {
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off, kTeam);
  return acc;
}

// sum (v - q)^2 (EUCLID) or sum v q over the row, partials of lane tl.
template <int U, bool VEC, bool EUCLID>
__device__ __forceinline__ void team_rows(const float* __restrict__ vectors, int D, const float* q,
                                          const long long (&row)[U], const bool (&ok)[U], int tl, float (&acc)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.0f;
  if (VEC) {
    const int D4 = D >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int c0 = 0; c0 < D4; c0 += 4 * kTeam) {
      float4 v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* r4 = reinterpret_cast<const float4*>(vectors + row[u] * D);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c0 + tl + k * kTeam;
          v[u][k] = (ok[u] && c < D4) ? __ldg(r4 + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + tl + k * kTeam;
        if (c < D4) {
          const float4 qq = q4[c];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (EUCLID) {
              const float a = v[u][k].x - qq.x, b = v[u][k].y - qq.y;
              const float e = v[u][k].z - qq.z, f = v[u][k].w - qq.w;
              acc[u] = fmaf(a, a, acc[u]);
              acc[u] = fmaf(b, b, acc[u]);
              acc[u] = fmaf(e, e, acc[u]);
              acc[u] = fmaf(f, f, acc[u]);
            } else {
              acc[u] = fmaf(v[u][k].x, qq.x, acc[u]);
              acc[u] = fmaf(v[u][k].y, qq.y, acc[u]);
              acc[u] = fmaf(v[u][k].z, qq.z, acc[u]);
              acc[u] = fmaf(v[u][k].w, qq.w, acc[u]);
            }
          }
        }
      }
    }
  } else {
    for (int d0 = 0; d0 < D; d0 += 4 * kTeam) {
      float v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int d = d0 + tl + k * kTeam;
          v[u][k] = (ok[u] && d < D) ? __ldg(vectors + row[u] * D + d) : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = d0 + tl + k * kTeam;
        if (d < D) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (EUCLID) {
              const float a = v[u][k] - q[d];
              acc[u] = fmaf(a, a, acc[u]);
            } else {
              acc[u] = fmaf(v[u][k], q[d], acc[u]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = team_sum(acc[u]);
}

template <int U, bool VEC>
__device__ __forceinline__ void score_euclidean(const float* __restrict__ vectors, int D, const float* q,
                                                const long long (&row)[U], const bool (&ok)[U], int tl,
                                                float (&dist)[U]) {
  team_rows<U, VEC, true>(vectors, D, q, row, ok, tl, dist);
}

template <int U, bool VEC>
__device__ __forceinline__ void score_inner(const float* __restrict__ vectors, int D, const float* q,
                                            const long long (&row)[U], const bool (&ok)[U], int tl, bool cosine,
                                            float (&dist)[U]) {
  team_rows<U, VEC, false>(vectors, D, q, row, ok, tl, dist);
#pragma unroll
  for (int u = 0; u < U; ++u) dist[u] = cosine ? 1.0f - dist[u] : -dist[u];
}

template <int U>
__device__ __forceinline__ void score_haversine(const float* __restrict__ vectors, const float* q,
                                                const long long (&row)[U], const bool (&ok)[U], int tl,
                                                float (&dist)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float d = 0.0f;
    if (ok[u] && tl == 0) {
      const float* v = vectors + row[u] * 2;
      d = haversine(q[0], q[1], __ldg(v), __ldg(v + 1));
    }
    dist[u] = d;
  }
}

template <int U, bool VEC>
__device__ __forceinline__ void score_rows(int metric, const float* __restrict__ vectors, int D, const float* q,
                                           const long long (&row)[U], const bool (&ok)[U], int tl,
                                           float (&dist)[U]) {
  if (metric == kEuclidean) score_euclidean<U, VEC>(vectors, D, q, row, ok, tl, dist);
  else if (metric == kHaversine) score_haversine<U>(vectors, q, row, ok, tl, dist);
  else score_inner<U, VEC>(vectors, D, q, row, ok, tl, metric == kCosine, dist);
}

// ---- The quantized routes. A walk is one template instance a route
// (ROUTE below): the f32 route scores with a team of kTeam lanes a row
// (score_rows above, the walk's first route, unchanged); the bit and ADC routes
// with one lane a row.

enum Route { kRouteF32 = 0, kRouteBit = 1, kRouteAdc = 2 };

template <int ROUTE>
__host__ __device__ constexpr int route_lanes() {
  return ROUTE == kRouteF32 ? kTeam : 1;
}

// Packed bits i32[cap, words], one lane a row: with vec (words % 4 == 0 on
// the 16-byte grid) a row comes in 16-byte loads, a whole row at D <= 128,
// and the query's first 4 words sit in registers (q0); else word by word
// (the query's words from shared memory). Hamming: the popcount of the xor,
// an exact f32. Jaccard: 1 - inter / union by one IEEE division, 0 where
// union == 0 (gather_bit_distance).
template <int U>
__device__ __forceinline__ void score_bits(const int32_t* __restrict__ codes, int words, bool vec, bool jaccard,
                                           const int* q, const int4& q0, const long long (&row)[U],
                                           const bool (&ok)[U], float (&dist)[U]) {
  int a[U], o[U];  // hamming: xor bits; jaccard: and bits, or bits
#pragma unroll
  for (int u = 0; u < U; ++u) a[u] = o[u] = 0;
  if (vec) {
    for (int w0 = 0; w0 < words; w0 += 4) {
      int4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = ok[u] ? __ldg(reinterpret_cast<const int4*>(codes + row[u] * words + w0)) : make_int4(0, 0, 0, 0);
      const int4 qq = w0 == 0 ? q0 : *reinterpret_cast<const int4*>(q + w0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (jaccard) {
          a[u] += __popc(x[u].x & qq.x) + __popc(x[u].y & qq.y) + __popc(x[u].z & qq.z) + __popc(x[u].w & qq.w);
          o[u] += __popc(x[u].x | qq.x) + __popc(x[u].y | qq.y) + __popc(x[u].z | qq.z) + __popc(x[u].w | qq.w);
        } else {
          a[u] += __popc(x[u].x ^ qq.x) + __popc(x[u].y ^ qq.y) + __popc(x[u].z ^ qq.z) + __popc(x[u].w ^ qq.w);
        }
      }
    }
  } else {
    for (int w = 0; w < words; ++w) {
      int x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = ok[u] ? __ldg(codes + row[u] * words + w) : 0;
      const int qq = q[w];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (jaccard) {
          a[u] += __popc(x[u] & qq);
          o[u] += __popc(x[u] | qq);
        } else {
          a[u] += __popc(x[u] ^ qq);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    dist[u] = !jaccard ? (float)a[u] : (o[u] == 0 ? 0.0f : __fsub_rn(1.0f, __fdiv_rn((float)a[u], (float)o[u])));
}

// PQ codes u8[cap, m] against the query's ADC table f32[m, k], one lane a
// row: with vec (m % 8 == 0 on the 8-byte grid) 8 codes a load, else one;
// the m terms summed in the order 0..m-1. The table is the query's copy in
// shared memory, or its rows in device memory (through L2) when it is too
// large to stage (kAdcStageBytes).
template <int U>
__device__ __forceinline__ void score_adc(const uint8_t* __restrict__ codes, int m, int k, bool vec,
                                          const float* table, const long long (&row)[U], const bool (&ok)[U],
                                          float (&dist)[U]) {
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.0f;
  if (vec) {
    for (int m0 = 0; m0 < m; m0 += 8) {
      uint2 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = ok[u] ? __ldg(reinterpret_cast<const uint2*>(codes + row[u] * m + m0)) : make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned c = ((j < 4 ? x[u].x : x[u].y) >> (8 * (j & 3))) & 0xffu;
          acc[u] = __fadd_rn(acc[u], table[(m0 + j) * k + c]);
        }
      }
    }
  } else {
    for (int j = 0; j < m; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned c = ok[u] ? __ldg(codes + row[u] * m + j) : 0u;
        acc[u] = __fadd_rn(acc[u], table[j * k + c]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) dist[u] = acc[u];
}

// The quantized routes' operands; the f32 route takes none of them.
struct Codes {
  const void* __restrict__ codes;  // bit: i32[cap, width]; ADC: u8[cap, width]
  int width;                        // a code row's words (bit) or bytes (ADC)
  int k;                            // ADC: centroids a subvector
  int vec;                          // the code rows' vector loads
  int jaccard;                      // bit: jaccard, else hamming
  int stage;                        // ADC: the table staged in shared memory
};

// U rows scored by the route; lane tl of the row's team of route_lanes.
template <int ROUTE, int U, bool VEC>
__device__ __forceinline__ void score_route(int metric, const float* __restrict__ vectors, int D, const float* q,
                                            const Codes& cq, const float* table, const long long (&row)[U],
                                            const bool (&ok)[U], int tl, float (&dist)[U]) {
  if constexpr (ROUTE == kRouteF32) {
    score_rows<U, VEC>(metric, vectors, D, q, row, ok, tl, dist);
  } else if constexpr (ROUTE == kRouteBit) {
    const int* qi = reinterpret_cast<const int*>(q);
    score_bits<U>(static_cast<const int32_t*>(cq.codes), cq.width, cq.vec != 0, cq.jaccard != 0, qi,
                  *reinterpret_cast<const int4*>(qi), row, ok, dist);
  } else {
    score_adc<U>(static_cast<const uint8_t*>(cq.codes), cq.width, cq.k, cq.vec != 0, table, row, ok, dist);
  }
}

// ---- One query's shared memory

struct Layout {
  int q, lk0, lk1, nk, le0, le1, nke, sv, dp, ring, cur, pos, wsum, misc, bytes;
};

__host__ __device__ inline int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

__host__ __device__ inline int take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) & ~15;
  return at;
}

// Byte offsets of one query's arrays (every one 16-byte aligned), and their
// sum. qwords: the 4-byte words of the query's staged form (query_words).
__host__ __device__ inline Layout layout_of(int qwords, int L, int W, int R, int S, int track) {
  Layout y;
  int off = 0;
  const int V = ((2 * L + W - 1) / W) * W;
  const int cap = pow2_at_least(W * R > S ? W * R : S);
  y.q = take(off, 4 * qwords);
  y.lk0 = take(off, 8 * L);
  y.lk1 = take(off, 8 * L);
  y.nk = take(off, 8 * L);
  y.le0 = take(off, L);
  y.le1 = take(off, L);
  y.nke = take(off, L);
  y.sv = take(off, 8 * cap);
  y.dp = take(off, 4 * (cap + 1));
  y.ring = take(off, track ? 8 * pow2_at_least(V) : 0);
  y.cur = take(off, 4 * W);
  y.pos = take(off, 4 * W);
  y.wsum = take(off, 8 * 8);
  y.misc = take(off, 4 * 8);
  y.bytes = off;
  return y;
}

// The query's staged form in shared memory, in 4-byte words: the f32 route's
// D floats and the bit route's code, each padded to a multiple of 4; the ADC
// route's table of m*k floats, or nothing when it is read through L2.
__host__ __device__ inline int query_words(int route, int width, int k, bool stage) {
  if (route == kRouteAdc) return stage ? width * k : 0;
  return (width + 3) & ~3;
}

enum Misc { kSurvivors = 0, kNonHole = 1, kSel = 2 };

struct State {
  float* q;
  u64* lk;  // the list's keys, in its order
  u64* lk_next;  // the next list, written by a merge; then the two swap
  unsigned char* le;  // expanded flags
  unsigned char* le_next;
  u64* nk;
  unsigned char* nke;
  u64* sv;
  int* dp;
  u64* ring;
  int* cur;
  int* pos;
  int* wsum;
  int* misc;
};

// Merge the `ns` survivors sv[0, ns) (real entries, unsorted) and `hnew`
// surviving new holes into the list; see the header's point 3.
template <int NW>
__device__ void merge(State& s, int L, int ns, int hnew, bool compact, const Team<NW>& t) {
  constexpr int T = Team<NW>::kThreads;
  const u64* lk = s.lk;
  const unsigned char* le = s.le;
  u64* out = s.lk_next;
  unsigned char* oute = s.le_next;
  const int np = pow2_at_least(ns);
  for (int j = ns + t.tid; j < np; j += T) s.sv[j] = kPad;
  t.sync();
  if (np > 1) team_sort(s.sv, np, t);
  // The list's real entries (in order, as they are sorted) and their flags
  int F = 0;
  for (int base = 0; base < L; base += T) {
    const int p = base + t.tid;
    const u64 k = p < L ? lk[p] : kHole;
    const bool real = p < L && k != kHole;
    int tot;
    const int pre = team_scan(real, s.wsum, tot, t);
    if (real) {
      s.nk[F + pre] = k;
      s.nke[F + pre] = le[p];
    }
    F += tot;
  }
  t.sync();
  // Survivors equal to their predecessor (a survivor or a list entry) are
  // dups; dp[j] counts those before j
  int ndup = 0;
  for (int base = 0; base < ns; base += T) {
    const int j = base + t.tid;
    bool dup = false;
    if (j < ns) {
      const u64 x = s.sv[j];
      const int c = count_at_or_below(s.nk, F, x);
      dup = (j > 0 && s.sv[j - 1] == x) || (c > 0 && s.nk[c - 1] == x);
    }
    int tot;
    const int pre = team_scan(dup, s.wsum, tot, t);
    if (j < ns) s.dp[j] = ndup + pre;
    ndup += tot;
  }
  if (t.tid == 0) s.dp[ns] = ndup;
  t.sync();
  const int holes = (L - F) + hnew;
  for (int j = t.tid; j < ns; j += T) {
    const u64 x = s.sv[j];
    const bool dup = s.dp[j + 1] != s.dp[j];
    const bool past = x > kHole;  // a real entry at inf: after the holes
    int p = j + count_at_or_below(s.nk, F, x) + (past ? holes : 0);
    if (compact) {
      if (dup) continue;
      p += past ? ndup - s.dp[j] : -s.dp[j];
    }
    if (p < L) {
      out[p] = dup ? kHole : x;
      oute[p] = 0;
    }
  }
  for (int i = t.tid; i < F; i += T) {
    const u64 k = s.nk[i];
    const bool past = k > kHole;
    const int c = count_below(s.sv, ns, k);
    int p = i + c + (past ? holes : 0);
    if (compact) p += past ? ndup - s.dp[c] : -s.dp[c];
    if (p < L) {
      out[p] = k;
      oute[p] = s.nke[i];
    }
  }
  {
    const int c = count_below(s.sv, ns, kHole);
    int start = count_below(s.nk, F, kHole) + c, len = holes;
    if (compact) {
      start -= s.dp[c];
      len += ndup;
    }
    const int end = start + len < L ? start + len : L;
    for (int p = start + t.tid; p < end; p += T) {
      out[p] = kHole;
      oute[p] = 0;
    }
  }
  t.sync();
  s.lk_next = s.lk;
  s.lk = out;
  s.le_next = s.le;
  s.le = oute;
}

// The list's largest key, and the survivors' bound: with compaction and a
// real entry at inf in the list, every new entry survives.
template <int NW>
__device__ __forceinline__ u64 survivor_bound(const State& s, int L, bool compact, const Team<NW>& t) {
  u64 m = 0;
  for (int p = t.tid; p < L; p += Team<NW>::kThreads) m = s.lk[p] > m ? s.lk[p] : m;
  const u64 top = team_max(m, reinterpret_cast<u64*>(s.wsum), t);
  return (compact && top > kHole) ? kPad : top;
}

// An uncompacted merge whose list holds holes and no real entry past them
// (its largest key is a hole) keeps its holes in place: a new entry past the
// list's largest real key can only take a hole's place, so of those only the
// (holes - a) smallest can enter (a: the survivors below that key). Keeps
// those survivors and the ones below, in place in sv; returns their count.
// (hole_cut in tests/test_torch_vamana_models.py.)
template <int NW>
__device__ int hole_cut(State& s, int L, int ns, const Team<NW>& t) {
  constexpr int T = Team<NW>::kThreads;
  u64* w64 = reinterpret_cast<u64*>(s.wsum);
  u64 top = 0;
  int holes = 0;
  for (int p = t.tid; p < L; p += T) {
    const u64 k = s.lk[p];
    if (k == kHole) ++holes;
    else top = k > top ? k : top;
  }
  top = team_max(top, w64, t);
  holes = team_add(holes, s.wsum, t);
  int below = 0;
  for (int j = t.tid; j < ns; j += T) below += s.sv[j] < top;
  const int need = holes - team_add(below, s.wsum, t);
  u64 cut = top;
  if (need > 0) {
    // The need-th smallest key at or past top, counting repeats
    cut = kPad;
    u64 prev = 0;
    bool first = true;
    for (int taken = 0;;) {
      u64 m = kPad;
      for (int j = t.tid; j < ns; j += T) {
        const u64 k = s.sv[j];
        if (k >= top && (first || k > prev) && k < m) m = k;
      }
      m = team_min(m, w64, t);
      if (m == kPad) break;
      int eq = 0;
      for (int j = t.tid; j < ns; j += T) eq += s.sv[j] == m;
      taken += team_add(eq, s.wsum, t);
      if (taken >= need) {
        cut = m + 1;
        break;
      }
      prev = m;
      first = false;
    }
  }
  int kept = 0;
  for (int base = 0; base < ns; base += T) {
    const int j = base + t.tid;
    const u64 k = j < ns ? s.sv[j] : kPad;
    const bool keep = j < ns && k < cut;
    t.sync();  // every read of this round before any write
    int tot;
    const int pre = team_scan(keep, s.wsum, tot, t);
    if (keep) s.sv[kept + pre] = k;
    kept += tot;
  }
  t.sync();
  return kept;
}

// Score slots [0, n_slots) (slot -> id by ids_of; NIL slots are holes) and
// keep the survivors (key < bound) in sv; counts real slots in misc.
template <int NW, int ROUTE, bool VEC, typename IdOf>
__device__ void score_slots(State& s, const float* __restrict__ vectors, long long cap, int D, int metric,
                            const Codes& cq, const float* table, int n_slots, u64 bound, IdOf ids_of,
                            const Team<NW>& t) {
  constexpr int U = kRowsInFlight;
  constexpr int LANES = route_lanes<ROUTE>();
  constexpr int RT = Team<NW>::kThreads / LANES;
  const int g = t.tid / LANES, tl = t.tid % LANES;
  int real = 0;
  for (int base = 0; base < n_slots; base += RT * U) {
    int id[U];
    bool ok[U];
    long long row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slot = base + u * RT + g;
      id[u] = slot < n_slots ? ids_of(slot) : kNil;
      ok[u] = id[u] != kNil;
      row[u] = id[u] < 0 ? 0 : (id[u] >= cap ? cap - 1 : id[u]);
    }
    float dist[U];
    score_route<ROUTE, U, VEC>(metric, vectors, D, s.q, cq, table, row, ok, tl, dist);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const u64 key = key_of(dist[u], id[u]);
      const bool keep = tl == 0 && ok[u] && key < bound;
      real += tl == 0 && ok[u];
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (m) {
        const int first = __ffs(m) - 1;
        int at = 0;
        if (t.lane == first) at = atomicAdd(&s.misc[kSurvivors], __popc(m));
        at = __shfl_sync(0xffffffffu, at, first);
        if (keep) s.sv[at + __popc(m & lanes_below(t.lane))] = key;
      }
    }
  }
  real = __reduce_add_sync(0xffffffffu, real);
  if (t.lane == 0 && real) atomicAdd(&s.misc[kNonHole], real);
}

template <int NW>
constexpr int block_threads() {
  return NW == 1 ? kWarpQueries * 32 : NW * 32;
}

template <int NW>
constexpr int min_blocks() {
  return NW == 1 ? kWarpMinBlocks : (NW == 4 ? 8 : 4);  // 64 registers a thread at 8 and 4
}

// One instance a (team size, route, f32 load width). queries: the f32
// route's f32[B, D], the bit route's query codes i32[B, width], the ADC
// route's tables f32[B, width, k]; cq the quantized routes' operands.
template <int NW, int ROUTE, bool VEC>
__global__ void __launch_bounds__(block_threads<NW>(), min_blocks<NW>()) vamana_beam_search_kernel(
    const float* __restrict__ vectors, long long cap, int D, const int32_t* __restrict__ adjacency, int R,
    const void* __restrict__ queries, int B, const int32_t* __restrict__ seeds, int S, int L, int W, int V,
    int max_hops, int metric, int track_visited, int team_bytes, float* __restrict__ cand_d,
    int32_t* __restrict__ cand_i, float* __restrict__ vis_d, int32_t* __restrict__ vis_i,
    int32_t* __restrict__ hops_out, int32_t* __restrict__ counts_out, const Codes cq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = Team<NW>::kThreads;
  Team<NW> t;
  t.tid = threadIdx.x % T;
  t.lane = threadIdx.x % 32;
  t.warp = t.tid / 32;
  const int b = blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  if (b >= B) return;  // a whole team (a warp: NW == 1 only has teams past B)
  const bool track = track_visited != 0;
  const int qw = ROUTE == kRouteF32 ? query_words(kRouteF32, D, 0, false)
                                    : query_words(ROUTE, cq.width, cq.k, cq.stage != 0);
  const Layout y = layout_of(qw, L, W, R, S, track_visited);
  unsigned char* base = smem_raw + (long long)(threadIdx.x / T) * team_bytes;
  State s;
  s.q = reinterpret_cast<float*>(base + y.q);
  s.lk = reinterpret_cast<u64*>(base + y.lk0);
  s.lk_next = reinterpret_cast<u64*>(base + y.lk1);
  s.nk = reinterpret_cast<u64*>(base + y.nk);
  s.le = base + y.le0;
  s.le_next = base + y.le1;
  s.nke = base + y.nke;
  s.sv = reinterpret_cast<u64*>(base + y.sv);
  s.dp = reinterpret_cast<int*>(base + y.dp);
  s.ring = reinterpret_cast<u64*>(base + y.ring);
  s.cur = reinterpret_cast<int*>(base + y.cur);
  s.pos = reinterpret_cast<int*>(base + y.pos);
  s.wsum = reinterpret_cast<int*>(base + y.wsum);
  s.misc = reinterpret_cast<int*>(base + y.misc);
  const int Vp = pow2_at_least(V);
  // The query's staged form: its f32 row, its code, or its ADC table
  const float* table = nullptr;
  if constexpr (ROUTE == kRouteF32) {
    const float* qg = static_cast<const float*>(queries) + (long long)b * D;
    for (int d = t.tid; d < qw; d += T) s.q[d] = d < D ? qg[d] : 0.0f;
  } else if constexpr (ROUTE == kRouteBit) {
    const int32_t* qg = static_cast<const int32_t*>(queries) + (long long)b * cq.width;
    int* qi = reinterpret_cast<int*>(s.q);
    for (int w = t.tid; w < qw; w += T) qi[w] = w < cq.width ? qg[w] : 0;
  } else {
    const long long mk = (long long)cq.width * cq.k;
    const float* tg = static_cast<const float*>(queries) + (long long)b * mk;
    table = tg;
    if (cq.stage) {
      table = s.q;
      if ((mk & 3) == 0) {
        const float4* t4 = reinterpret_cast<const float4*>(tg);
        float4* s4 = reinterpret_cast<float4*>(s.q);
        for (int i = t.tid; i < (int)(mk >> 2); i += T) s4[i] = __ldg(t4 + i);
      } else {
        for (int i = t.tid; i < (int)mk; i += T) s.q[i] = __ldg(tg + i);
      }
    }
  }
  for (int p = t.tid; p < L; p += T) {
    s.lk[p] = kHole;
    s.le[p] = 0;
  }
  if (track)
    for (int p = t.tid; p < Vp; p += T) s.ring[p] = p < V ? kHole : kPad;
  if (t.tid < 8) s.misc[t.tid] = 0;
  t.sync();
  // The start node: the first team of lanes scores it (the whole first warp calls)
  if (t.warp == 0) {
    constexpr int LANES = route_lanes<ROUTE>();
    const long long row[1] = {kStartId < cap ? kStartId : cap - 1};
    const bool ok[1] = {t.lane < LANES};
    float dist[1];
    score_route<ROUTE, 1, VEC>(metric, vectors, D, s.q, cq, table, row, ok, t.lane % LANES, dist);
    if (t.lane == 0) s.lk[0] = key_of(dist[0], kStartId);
  }
  t.sync();
  int scored = 0;
  if (seeds != nullptr && S > 0) {
    const int32_t* sg = seeds + (long long)b * S;
    const u64 bound = survivor_bound(s, L, true, t);
    score_slots<NW, ROUTE, VEC>(s, vectors, cap, D, metric, cq, table, S, bound,
                                [&](int slot) { const int id = sg[slot]; return id == kStartId ? kNil : id; }, t);
    t.sync();
    const int ns = s.misc[kSurvivors], real = s.misc[kNonHole];
    scored += real;
    t.sync();
    if (t.tid == 0) s.misc[kSurvivors] = s.misc[kNonHole] = 0;
    merge(s, L, ns, bound > kHole ? S - real : 0, true, t);
  }
  const int ring_blocks = V / W;
  int hop = 0, expanded = 0;
  while (hop < max_hops) {
    // The W earliest unexpanded positions
    int found = 0;
    for (int base = 0; base < L && found < W; base += T) {
      const int p = base + t.tid;
      bool u = false;
      if (p < L) {
        const u64 k = s.lk[p];
        u = id_of(k) != kNil && !s.le[p] && isfinite(dist_of(k));
      }
      int tot;
      const int pre = team_scan(u, s.wsum, tot, t);
      if (u && found + pre < W) s.pos[found + pre] = p;
      found += tot;
    }
    const int nsel = found < W ? found : W;
    if (nsel == 0) break;
    t.sync();
    for (int w = t.tid; w < nsel; w += T) {
      const int p = s.pos[w];
      const u64 k = s.lk[p];
      s.le[p] = 1;
      if (track) s.ring[(hop % ring_blocks) * W + w] = k;
      s.cur[w] = id_of(k);
    }
    t.sync();
    expanded += nsel;
    const u64 bound = survivor_bound(s, L, track, t);
    const float inv_r = 1.0f / R;  // slot / R exactly: slot + 0.5 lies 0.5 / R from a multiple of R
    score_slots<NW, ROUTE, VEC>(s, vectors, cap, D, metric, cq, table, nsel * R, bound,
                                [&](int slot) {
                                  const int w = __float2int_rz((slot + 0.5f) * inv_r);
                                  const int c = s.cur[w];
                                  const long long row = c < 0 ? 0 : (c >= cap ? cap - 1 : c);
                                  return (int)__ldg(adjacency + row * R + (slot - w * R));
                                },
                                t);
    t.sync();
    int ns = s.misc[kSurvivors];
    const int real = s.misc[kNonHole];
    scored += real;
    t.sync();
    if (t.tid == 0) s.misc[kSurvivors] = s.misc[kNonHole] = 0;
    if (!track && bound == kHole && ns > 0) ns = hole_cut(s, L, ns, t);
    merge(s, L, ns, bound > kHole ? W * R - real : 0, track, t);
    ++hop;
  }
  float* cd = cand_d + (long long)b * L;
  int32_t* ci = cand_i + (long long)b * L;
  for (int p = t.tid; p < L; p += T) {
    const u64 k = s.lk[p];
    cd[p] = dist_of(k);
    ci[p] = id_of(k);
  }
  float* vdo = vis_d + (long long)b * V;
  int32_t* vio = vis_i + (long long)b * V;
  if (track) {
    team_sort(s.ring, Vp, t);
    for (int p = t.tid; p < V; p += T) {
      vdo[p] = dist_of(s.ring[p]);
      vio[p] = id_of(s.ring[p]);
    }
  } else {
    for (int p = t.tid; p < V; p += T) {
      vdo[p] = __int_as_float(0x7f800000);
      vio[p] = kNil;
    }
  }
  if (t.tid == 0) {
    hops_out[b] = hop;
    counts_out[2 * b] = expanded;
    counts_out[2 * b + 1] = scored;
  }
}

struct Geometry {
  int nw, qpb, team_bytes;
};

// Warps a query and queries a block: one warp a query where a hop brings at most kWarpMaxNew new
// entries (seeds included), kWarpQueries a block as far as shared memory
// allows; else a block a query, of 8 warps for a batch of at most
// kSmallBatch queries and 4 for a larger one. The same rule for every route;
// qwords is the route's staged query (query_words).
Geometry pick_geometry(int B, int L, int W, int R, int qwords, int S, int track) {
  Geometry g;
  const int most_new = W * R > S ? W * R : S;
  g.nw = most_new <= kWarpMaxNew ? 1 : (B <= kSmallBatch ? 8 : 4);
  g.team_bytes = layout_of(qwords, L, W, R, S, track).bytes;
  g.qpb = 1;
  if (g.nw == 1) {
    const long long fit = kSmemBudget / g.team_bytes;
    g.qpb = fit < kWarpQueries ? (fit < 1 ? 1 : (int)fit) : kWarpQueries;
  }
  return g;
}

// A launch's operands, as the kernel takes them.
struct Walk {
  const float* vectors;
  long long cap;
  int D;
  const int32_t* adjacency;
  int R;
  const void* queries;
  int B;
  const int32_t* seeds;
  int S, L, W, V, max_hops, metric, track;
  float* cand_d;
  int32_t* cand_i;
  float* vis_d;
  int32_t* vis_i;
  int32_t* hops;
  int32_t* counts;
  Codes cq;
};

template <int NW, int ROUTE, bool VEC>
cudaError_t launch_as(const Geometry& g, const Walk& a, cudaStream_t stream) {
  const int smem = g.team_bytes * g.qpb;
  cudaError_t err = smem_opt_in((const void*)vamana_beam_search_kernel<NW, ROUTE, VEC>, (size_t)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + g.qpb - 1) / g.qpb;
  vamana_beam_search_kernel<NW, ROUTE, VEC><<<blocks, g.qpb * NW * 32, smem, stream>>>(
      a.vectors, a.cap, a.D, a.adjacency, a.R, a.queries, a.B, a.seeds, a.S, a.L, a.W, a.V, a.max_hops, a.metric,
      a.track, g.team_bytes, a.cand_d, a.cand_i, a.vis_d, a.vis_i, a.hops, a.counts, a.cq);
  return cudaGetLastError();
}

template <int ROUTE, bool VEC>
cudaError_t launch_route(const Geometry& g, const Walk& a, cudaStream_t stream) {
  if (g.nw == 1) return launch_as<1, ROUTE, VEC>(g, a, stream);
  if (g.nw == 4) return launch_as<4, ROUTE, VEC>(g, a, stream);
  return launch_as<8, ROUTE, VEC>(g, a, stream);
}

// The checks shared by both entry points (the walk's sizes).
bool walk_sizes_ok(long long cap, int R, int B, int S, int L, int W) {
  return cap >= 1 && cap <= 0x7ffffffeLL && R >= 1 && B >= 1 && L >= 1 && L <= kMaxL && W >= 1 && W <= L &&
         W * R <= kMaxWR && S >= 0 && L + S <= kMaxM;
}

Walk walk_of(long long cap, const void* adjacency, int R, const void* queries, int B, const void* seeds, int S,
             int L, int W, int max_hops, int track_visited, void* cand_d, void* cand_i, void* vis_d, void* vis_i,
             void* hops, void* counts) {
  Walk a{};
  a.cap = cap;
  a.adjacency = static_cast<const int32_t*>(adjacency);
  a.R = R;
  a.queries = queries;
  a.B = B;
  a.seeds = static_cast<const int32_t*>(seeds);
  a.S = S;
  a.L = L;
  a.W = W;
  a.V = ((2 * L + W - 1) / W) * W;
  a.max_hops = max_hops;
  a.track = track_visited != 0;
  a.cand_d = static_cast<float*>(cand_d);
  a.cand_i = static_cast<int32_t*>(cand_i);
  a.vis_d = static_cast<float*>(vis_d);
  a.vis_i = static_cast<int32_t*>(vis_i);
  a.hops = static_cast<int32_t*>(hops);
  a.counts = static_cast<int32_t*>(counts);
  return a;
}

}  // namespace

extern "C" {

// Pointers are device pointers; seeds may be null (S = 0). metric: 0
// euclidean, 1 dot, 2 cosine, 3 haversine. M is the first design's merge
// buffer length, a power of two >= max(L + W*R, L + S, V) and <= 2048; it is
// checked as it was and sizes nothing now. Returns cudaGetLastError() after
// the launch (0 on success). Launches on `stream`; does not synchronise.
int semadb_vamana_beam_search(const void* vectors, long long cap, int D, const void* adjacency, int R,
                              const void* queries, int B, const void* seeds, int S, int L, int W, int M,
                              int max_hops, int metric, int track_visited, void* cand_d,
                              void* cand_i, void* vis_d, void* vis_i, void* hops, void* counts, void* stream) {
  const int V = ((2 * L + W - 1) / W) * W;
  if (!walk_sizes_ok(cap, R, B, S, L, W) || D < 1 || D > kMaxD || M > kMaxM || M < L + W * R || M < L + S ||
      M < V || (M & (M - 1)) != 0 || metric < 0 || metric > 3 || (metric == kHaversine && D != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int track = track_visited != 0;
  const Geometry g = pick_geometry(B, L, W, R, query_words(kRouteF32, D, 0, false), S, track);
  if ((long long)g.team_bytes * g.qpb > kSmemBudget) return (int)cudaErrorInvalidValue;
  Walk a = walk_of(cap, adjacency, R, queries, B, seeds, S, L, W, max_hops, track, cand_d, cand_i, vis_d, vis_i,
                   hops, counts);
  a.vectors = static_cast<const float*>(vectors);
  a.D = D;
  a.metric = metric;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(vectors) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_route<kRouteF32, true>(g, a, st) : launch_route<kRouteF32, false>(g, a, st));
}

// The quantized walk. route 1 (bits): codes i32[cap, width] packed bits,
// prepared i32[B, width] the queries' codes, bit_metric 0 hamming, 1
// jaccard. route 2 (ADC): codes u8[cap, width] PQ codes, prepared f32[B,
// width, k] the queries' tables, staged in shared memory when a table holds
// at most kAdcStageBytes and the team's memory fits, else read through L2.
// The rest as semadb_vamana_beam_search.
int semadb_vamana_beam_search_codes(const void* codes, long long cap, int route, int width, int k, int bit_metric,
                                    const void* adjacency, int R, const void* prepared, int B, const void* seeds,
                                    int S, int L, int W, int max_hops, int track_visited, void* cand_d,
                                    void* cand_i, void* vis_d, void* vis_i, void* hops, void* counts,
                                    void* stream) {
  if (!walk_sizes_ok(cap, R, B, S, L, W) || width < 1 || width > kMaxD ||
      (route == kRouteBit && (bit_metric < 0 || bit_metric > 1)) ||
      (route == kRouteAdc && (k < 1 || k > 256)) || (route != kRouteBit && route != kRouteAdc)) {
    return (int)cudaErrorInvalidValue;
  }
  const int track = track_visited != 0;
  bool stage = route == kRouteAdc && (long long)width * k * 4 <= kAdcStageBytes;
  Geometry g = pick_geometry(B, L, W, R, query_words(route, width, k, stage), S, track);
  if (stage && (long long)g.team_bytes > kSmemBudget) {
    stage = false;
    g = pick_geometry(B, L, W, R, query_words(route, width, k, stage), S, track);
  }
  if ((long long)g.team_bytes * g.qpb > kSmemBudget) return (int)cudaErrorInvalidValue;
  Walk a = walk_of(cap, adjacency, R, prepared, B, seeds, S, L, W, max_hops, track, cand_d, cand_i, vis_d, vis_i,
                   hops, counts);
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
  a.cq.codes = codes;
  a.cq.width = width;
  a.cq.k = k;
  a.cq.jaccard = route == kRouteBit && bit_metric == 1;
  a.cq.stage = stage;
  a.cq.vec = route == kRouteBit ? (width % 4 == 0 && (at & 15) == 0) : (width % 8 == 0 && (at & 7) == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(route == kRouteBit ? launch_route<kRouteBit, false>(g, a, st)
                                  : launch_route<kRouteAdc, false>(g, a, st));
}

const char* semadb_vamana_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
