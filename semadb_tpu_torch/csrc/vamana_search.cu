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
// What the design does about it. This is the first, simple design: one block
// of 256 threads a query holds the query, the list, the ring and the merge
// buffer in shared memory for the whole walk, so nothing but the rows it
// scores and the adjacency rows it reads crosses device memory, and there is
// one launch for all the hops (the plain version makes some 40 launches a
// hop). Rows are scored by teams of 8 lanes, each lane reading every 8th
// element, so each team reads 32-byte sectors and 32 rows are in flight a
// block. The merge is a bitonic sort of the padded buffer (a power of two,
// at most 2,048 entries) in shared memory, then the dedup pass and, with
// compaction, a second sort. Not done yet: rows already in the list are
// scored again; the list is sorted whole where a merge of two sorted runs
// would do; blocks do not share rows through shared memory.
// L <= 512, W * R <= 512, W <= L, L + S <= 2048, D <= 4096.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vamana_common.cuh"

#define kInf __int_as_float(0x7f800000)

namespace {

using namespace vamana;

constexpr int kStartId = 1;
constexpr int kThreads = 256;
constexpr int kTeam = 8;  // lanes that score one row
constexpr int kTeams = kThreads / kTeam;
constexpr int kMaxL = 512;
constexpr int kMaxWR = 512;
constexpr int kMaxM = 2048;
constexpr int kMaxD = 4096;
constexpr int kPadId = 0x7fffffff;  // padding sorts after every real entry
// (d, id, x) order: distance, then id, then x (bit 1: a new entry, after the
// list's own; bit 0: expanded). Equal distances, -0.0 and 0.0 among them,
// fall to the id, as in jax.lax.sort.
__device__ __forceinline__ bool key_less(float da, int ia, int xa, float db, int ib, int xb) {
  if (da < db) return true;
  if (db < da) return false;
  if (ia != ib) return ia < ib;
  return xa < xb;
}

__device__ void bitonic_sort(float* d, int* id, int* x, int m) {
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (m >> 1); t += kThreads) {
        const int i = 2 * j * (t / j) + (t % j);
        const int l = i + j;
        const bool up = (i & k) == 0;
        const bool lt = key_less(d[l], id[l], x[l], d[i], id[i], x[i]);
        const bool gt = key_less(d[i], id[i], x[i], d[l], id[l], x[l]);
        if (up ? lt : gt) {
          const float td = d[i]; d[i] = d[l]; d[l] = td;
          const int ti = id[i]; id[i] = id[l]; id[l] = ti;
          const int tx = x[i]; x[i] = x[l]; x[l] = tx;
        }
      }
      __syncthreads();
    }
  }
}

struct Smem {
  float* q;      // [D]
  float* ld;     // list [L]
  int* li;
  int* le;       // expanded flags
  float* bd;     // merge buffer [M]
  int* bi;
  int* bx;
  float* vd;     // ring [V]
  int* vi;
  int* cur;      // this hop's selected ids [W]
  int* misc;     // [0] selected count
};

// Sort buf[0, n) (padded to m), empty every entry whose id repeats its
// predecessor's, optionally sort again, and take the first L as the list.
__device__ void merge_into_list(Smem& s, int n, int m, int L, bool compact) {
  for (int j = n + threadIdx.x; j < m; j += kThreads) {
    s.bd[j] = kInf; s.bi[j] = kPadId; s.bx[j] = 3;
  }
  __syncthreads();
  bitonic_sort(s.bd, s.bi, s.bx, m);
  constexpr int kPer = kMaxM / kThreads;
  bool dup[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreads;
    dup[k] = j >= 1 && j < n && s.bi[j] == s.bi[j - 1] && s.bi[j] != kNil;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (dup[k]) { s.bd[j] = kInf; s.bi[j] = kNil; s.bx[j] = 0; }
  }
  __syncthreads();
  if (compact) bitonic_sort(s.bd, s.bi, s.bx, m);
  for (int p = threadIdx.x; p < L; p += kThreads) {
    s.ld[p] = s.bd[p]; s.li[p] = s.bi[p]; s.le[p] = s.bx[p] & 1;
  }
  __syncthreads();
}

// The distance of row `row` to the query, reduced over a team of kTeam lanes
// (every lane of the warp calls it; `ok` false lanes contribute nothing).
__device__ __forceinline__ float team_distance(const float* __restrict__ vectors, long long row, int D,
                                               const float* q, int metric, bool ok, int tl) {
  float acc = 0.0f;
  if (metric == kHaversine) {
    if (ok && tl == 0) {
      const float* v = vectors + row * D;
      acc = haversine(q[0], q[1], v[0], v[1]);
    }
    return acc;
  }
  if (ok) {
    const float* v = vectors + row * D;
    if (metric == kEuclidean) {
#pragma unroll 4
      for (int d = tl; d < D; d += kTeam) {
        const float diff = __ldg(v + d) - q[d];
        acc += diff * diff;
      }
    } else {
#pragma unroll 4
      for (int d = tl; d < D; d += kTeam) acc += __ldg(v + d) * q[d];
    }
  }
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off, kTeam);
  if (metric == kDot) return -acc;
  if (metric == kCosine) return 1.0f - acc;
  return acc;
}

// Score candidates into buf[L + s] for s < n_slots: slot s is the neighbour
// (or seed) id ids_of(s); non-valid slots become (inf, -1).
template <typename IdOf>
__device__ void score_slots(Smem& s, const float* __restrict__ vectors, long long cap, int D, int metric,
                            int L, int n_slots, IdOf ids_of, int* scored) {
  const int team = threadIdx.x / kTeam, tl = threadIdx.x % kTeam;
  int count = 0;
  for (int base = 0; base < n_slots; base += kTeams) {
    const int slot = base + team;
    int id = kNil;
    bool ok = false;
    if (slot < n_slots) {
      id = ids_of(slot);
      ok = id != kNil;
    }
    long long row = id < 0 ? 0 : (id >= cap ? cap - 1 : id);
    const float dist = team_distance(vectors, row, D, s.q, metric, ok, tl);
    if (slot < n_slots && tl == 0) {
      s.bd[L + slot] = ok ? dist : kInf;
      s.bi[L + slot] = ok ? id : kNil;
      s.bx[L + slot] = 2;
      count += ok;
    }
  }
  if (tl == 0 && count) atomicAdd(scored, count);
}

__global__ void __launch_bounds__(kThreads) vamana_beam_search_kernel(
    const float* __restrict__ vectors, long long cap, int D, const int32_t* __restrict__ adjacency, int R,
    const float* __restrict__ queries, const int32_t* __restrict__ seeds, int S, int L, int W, int V, int M,
    int max_hops, int metric, int track_visited, float* __restrict__ cand_d,
    int32_t* __restrict__ cand_i, float* __restrict__ vis_d, int32_t* __restrict__ vis_i,
    int32_t* __restrict__ hops_out, int32_t* __restrict__ counts_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  {
    unsigned char* p = smem_raw;
    auto take = [&](size_t bytes) { unsigned char* r = p; p += (bytes + 15) & ~size_t(15); return r; };
    s.q = reinterpret_cast<float*>(take(sizeof(float) * D));
    s.ld = reinterpret_cast<float*>(take(sizeof(float) * L));
    s.li = reinterpret_cast<int*>(take(sizeof(int) * L));
    s.le = reinterpret_cast<int*>(take(sizeof(int) * L));
    s.bd = reinterpret_cast<float*>(take(sizeof(float) * M));
    s.bi = reinterpret_cast<int*>(take(sizeof(int) * M));
    s.bx = reinterpret_cast<int*>(take(sizeof(int) * M));
    s.vd = reinterpret_cast<float*>(take(sizeof(float) * V));
    s.vi = reinterpret_cast<int*>(take(sizeof(int) * V));
    s.cur = reinterpret_cast<int*>(take(sizeof(int) * W));
    s.misc = reinterpret_cast<int*>(take(sizeof(int) * 4));
  }
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* qg = queries + (long long)b * D;
  for (int d = threadIdx.x; d < D; d += kThreads) s.q[d] = qg[d];
  for (int p = threadIdx.x; p < L; p += kThreads) { s.ld[p] = kInf; s.li[p] = kNil; s.le[p] = 0; }
  for (int p = threadIdx.x; p < V; p += kThreads) { s.vd[p] = kInf; s.vi[p] = kNil; }
  if (threadIdx.x < 4) s.misc[threadIdx.x] = 0;
  __syncthreads();
  // The start node: team 0 scores it (every lane of warp 0 takes part)
  if (warp == 0) {
    const long long row = kStartId < cap ? kStartId : cap - 1;
    const float dist = team_distance(vectors, row, D, s.q, metric, lane < kTeam, lane % kTeam);
    if (lane == 0) { s.ld[0] = dist; s.li[0] = kStartId; }
  }
  __syncthreads();
  if (seeds != nullptr && S > 0) {
    const int32_t* sg = seeds + (long long)b * S;
    for (int p = threadIdx.x; p < L; p += kThreads) { s.bd[p] = s.ld[p]; s.bi[p] = s.li[p]; s.bx[p] = s.le[p]; }
    score_slots(s, vectors, cap, D, metric, L, S,
                [&](int slot) { const int id = sg[slot]; return id == kStartId ? kNil : id; }, &s.misc[2]);
    __syncthreads();
    merge_into_list(s, L + S, M, L, true);
  }
  const int ring_blocks = V / W;
  int hop = 0;
  int expanded = 0;
  while (hop < max_hops) {
    // The W earliest unexpanded positions (warp 0, a ballot per 32 slots)
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < L && found < W; base += 32) {
        const int p = base + lane;
        const bool u = p < L && s.li[p] != kNil && !s.le[p] && isfinite(s.ld[p]);
        const unsigned m = __ballot_sync(0xffffffffu, u);
        const int r = found + __popc(m & ((1u << lane) - 1u));
        if (u && r < W) {
          s.cur[r] = p;  // a position for now
        }
        found += __popc(m);
      }
      if (lane == 0) s.misc[0] = found < W ? found : W;
    }
    __syncthreads();
    const int nsel = s.misc[0];
    if (nsel == 0) break;
    for (int w = threadIdx.x; w < nsel; w += kThreads) {
      const int p = s.cur[w];
      const int id = s.li[p];
      s.le[p] = 1;
      if (track_visited) {
        const int slot = (hop % ring_blocks) * W + w;
        s.vd[slot] = s.ld[p];
        s.vi[slot] = id;
      }
      s.cur[w] = id;
    }
    __syncthreads();
    expanded += nsel;
    for (int p = threadIdx.x; p < L; p += kThreads) { s.bd[p] = s.ld[p]; s.bi[p] = s.li[p]; s.bx[p] = s.le[p]; }
    const int n_live = nsel * R;
    score_slots(s, vectors, cap, D, metric, L, n_live,
                [&](int slot) {
                  const int c = s.cur[slot / R];
                  const long long row = c < 0 ? 0 : (c >= cap ? cap - 1 : c);
                  return (int)__ldg(adjacency + row * R + slot % R);
                },
                &s.misc[2]);
    for (int j = L + n_live + threadIdx.x; j < L + W * R; j += kThreads) {
      s.bd[j] = kInf; s.bi[j] = kNil; s.bx[j] = 2;
    }
    __syncthreads();
    merge_into_list(s, L + W * R, M, L, track_visited != 0);
    ++hop;
  }
  float* cd = cand_d + (long long)b * L;
  int32_t* ci = cand_i + (long long)b * L;
  for (int p = threadIdx.x; p < L; p += kThreads) { cd[p] = s.ld[p]; ci[p] = s.li[p]; }
  // The ring, sorted by (d, id)
  int mv = 1;
  while (mv < V) mv <<= 1;
  for (int p = threadIdx.x; p < mv; p += kThreads) {
    if (p < V) { s.bd[p] = s.vd[p]; s.bi[p] = s.vi[p]; s.bx[p] = 0; }
    else { s.bd[p] = kInf; s.bi[p] = kPadId; s.bx[p] = 3; }
  }
  __syncthreads();
  bitonic_sort(s.bd, s.bi, s.bx, mv);
  float* vdo = vis_d + (long long)b * V;
  int32_t* vio = vis_i + (long long)b * V;
  for (int p = threadIdx.x; p < V; p += kThreads) { vdo[p] = s.bd[p]; vio[p] = s.bi[p]; }
  if (threadIdx.x == 0) {
    hops_out[b] = hop;
    counts_out[2 * b] = expanded;
    counts_out[2 * b + 1] = s.misc[2];
  }
}

// Bytes of dynamic shared memory one block takes at these sizes.
long long smem_bytes(int D, int L, int W, int V, int M) {
  auto r = [](long long b) { return (b + 15) & ~15LL; };
  return r(4LL * D) + 3 * r(4LL * L) + 3 * r(4LL * M) + 2 * r(4LL * V) + r(4LL * W) + r(16);
}

}  // namespace

extern "C" {

// Pointers are device pointers; seeds may be null (S = 0). metric: 0
// euclidean, 1 dot, 2 cosine, 3 haversine. M is the merge buffer's length, a
// power of two >= max(L + W*R, L + S, V). Returns cudaGetLastError() after the
// launch (0 on success). Launches on `stream`; does not synchronise.
int semadb_vamana_beam_search(const void* vectors, long long cap, int D, const void* adjacency, int R,
                              const void* queries, int B, const void* seeds, int S, int L, int W, int M,
                              int max_hops, int metric, int track_visited, void* cand_d,
                              void* cand_i, void* vis_d, void* vis_i, void* hops, void* counts, void* stream) {
  const int V = ((2 * L + W - 1) / W) * W;
  if (cap < 1 || D < 1 || D > kMaxD || R < 1 || B < 1 || L < 1 || L > kMaxL || W < 1 || W > L ||
      W * R > kMaxWR || S < 0 || L + S > kMaxM || M > kMaxM || M < L + W * R || M < L + S || M < V ||
      (M & (M - 1)) != 0 || metric < 0 || metric > 3 || (metric == kHaversine && D != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = smem_bytes(D, L, W, V, M);
  cudaError_t err = cudaFuncSetAttribute(vamana_beam_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  vamana_beam_search_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), cap, D, static_cast<const int32_t*>(adjacency), R,
      static_cast<const float*>(queries), static_cast<const int32_t*>(seeds), S, L, W, V, M, max_hops, metric,
      track_visited, static_cast<float*>(cand_d), static_cast<int32_t*>(cand_i),
      static_cast<float*>(vis_d), static_cast<int32_t*>(vis_i), static_cast<int32_t*>(hops),
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

const char* semadb_vamana_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
