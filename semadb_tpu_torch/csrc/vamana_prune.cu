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
// k11_least_bytes); the arithmetic, D multiply-adds for each pair of live
// candidates computed (at most the upper triangle of the live ones, 3.2 M at
// P = 224, D = 128), is some 10-30 operations a byte, below the card's ratio.
//
// What the design does about it (the second design; the first, one serial
// step of three barriers a kept candidate with one 128-long dependent FMA
// chain a thread, ran at 1.4% of the bound):
//   1. The live candidates are compacted (a block scan) and their rows staged
//      once in shared memory, in f32 (asynchronous 16-byte copies, all in
//      flight at once), at a row stride of D + 4 floats (zero padded) so
//      that 8 lanes' 16-byte loads of 8 rows fall on distinct banks; the
//      stage holds at most kStageBudget bytes so that two blocks share an
//      SM. A pool with more live rows than that (P = 1,500, or D = 1,536)
//      reads them from device memory where they lie, through L2.
//   2. Panel by panel, the next kPanel live candidates (in pool order, dead
//      ones skipped) against every later live candidate: a register-tiled
//      FFMA product (a warp takes 8 panel rows, a lane 2 columns, 16
//      independent accumulators), each cross product and each sq summed over
//      d in ascending order with fmaf, as the first design's dot_rows did, so
//      every decision is the first design's bit for bit. A pair's kill test
//      alpha * pd < cand_d[j] is a bit in the column's 32-bit mask.
//   3. One warp runs the greedy over the panel from the masks: the first
//      live panel row is kept and the rows it kills drop out of the panel
//      (a ballot), with nothing but the warp inside; then every later column
//      that a kept row kills dies (km & kept), and the next panel is taken.
//      It stops at r_stop, so panels past it are never computed.
// This is the model tests/test_torch_vamana_models.py holds equal to
// robust_prune_plain (k11_panel_model). P <= 2048, D <= 4096.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_optin.cuh"
#include "vamana_common.cuh"

namespace {

using namespace vamana;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;                // live candidates a panel
constexpr int kRowsPerWarp = 8;           // panel rows a warp's tile
constexpr int kColsPerLane = 2;           // columns a lane's tile
constexpr int kColsPerPass = 128;         // columns the block covers in one pass
constexpr int kMaxP = 2048;
constexpr int kMaxD = 4096;
constexpr long long kStageBudget = 112 * 1024;  // a block's shared memory: two blocks an SM

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Exclusive prefix of `pred` over the block, in thread order; the count goes
// to `total`.
__device__ __forceinline__ int block_scan(bool pred, int* wsum, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) wsum[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = wsum[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  total = all;
  return before + __popc(m & lanes_below(lane));
}

// Where a live candidate's row lies: staged (shared memory, padded stride)
// or in device memory (its clipped id's row of `vectors`).
struct Rows {
  const float* staged_rows;  // shared memory
  const float* vectors;
  int stride;  // floats between staged rows
  const int* ids;
  long long cap;
  int D;
  bool staged;
  template <int MODE>
  __device__ __forceinline__ const float* row(int i) const {
    if (MODE == 0) return staged_rows + (long long)i * stride;
    const int id = ids[i];
    return vectors + (id < 0 ? 0 : (id >= cap ? cap - 1 : id)) * (long long)D;
  }
};

// Elements [4c, 4c + 4) of a row, 0 past D. MODE 0: staged (padded); 1:
// device memory, 16-byte loads; 2: device memory, element loads.
template <int MODE>
__device__ __forceinline__ float4 load4(const float* r, int c, int D) {
  if (MODE == 0) return *reinterpret_cast<const float4*>(r + 4 * c);
  if (MODE == 1) return __ldg(reinterpret_cast<const float4*>(r) + c);
  const int d = 4 * c;
  return make_float4(d < D ? __ldg(r + d) : 0.0f, d + 1 < D ? __ldg(r + d + 1) : 0.0f,
                     d + 2 < D ? __ldg(r + d + 2) : 0.0f, d + 3 < D ? __ldg(r + d + 3) : 0.0f);
}

// A 16-byte copy from device to shared memory that does not wait for its
// data (cp.async); copies_wait() waits for all of the thread's.
__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int MODE>
__device__ float self_dot(const float* r, int D) {
  float acc = 0.0f;
  const int C = (D + 3) >> 2;
  for (int c = 0; c < C; ++c) {
    const float4 v = load4<MODE>(r, c, D);
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    acc = fmaf(v.w, v.w, acc);
  }
  return acc;
}

struct Prune {
  const float* ld;  // [n] live candidates' distances
  const int* lid;   // [n] their ids
  const float* sq;  // [n] squared norms (euclidean)
  const int* al;    // [m] this round's live candidates (indices into ld/lid)
  unsigned* km;     // [m] kill masks: bit i, panel row i kills column c
  int m, np, metric;
  float alpha;
};

// The kill masks of the panel (al[0, np)) against every column al[c] with
// c > its row, c < m: bit i of km[c] when alpha * pd(al[i], al[c]) < d.
template <int MODE>
__device__ void panel_kills(const Prune& pr, const Rows& rows) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = (warp % 4) * kRowsPerWarp;  // this warp's panel rows
  if (r0 >= pr.np) return;
  const int C = (rows.D + 3) >> 2;
  for (int col0 = (warp / 4) * (kColsPerPass / 2); col0 < pr.m; col0 += kColsPerPass) {
    int col[kColsPerLane];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      col[k] = col0 + lane + 32 * k;
      any |= col[k] < pr.m && col[k] > r0;
    }
    if (!any) continue;
    const float* a[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) a[r] = rows.template row<MODE>(pr.al[min(r0 + r, pr.np - 1)]);
    const float* b[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) b[k] = rows.template row<MODE>(pr.al[min(col[k], pr.m - 1)]);
    float pd[kRowsPerWarp][kColsPerLane];
    if (pr.metric == kHaversine) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) pd[r][k] = haversine(a[r][0], a[r][1], b[k][0], b[k][1]);
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) pd[r][k] = 0.0f;
      for (int c = 0; c < C; ++c) {
        float4 v[kColsPerLane];
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) v[k] = load4<MODE>(b[k], c, rows.D);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 u = load4<MODE>(a[r], c, rows.D);
#pragma unroll
          for (int k = 0; k < kColsPerLane; ++k) {
            float acc = pd[r][k];
            acc = fmaf(u.x, v[k].x, acc);
            acc = fmaf(u.y, v[k].y, acc);
            acc = fmaf(u.z, v[k].z, acc);
            acc = fmaf(u.w, v[k].w, acc);
            pd[r][k] = acc;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = col[k];
      if (c >= pr.m) continue;
      const int j = pr.al[c];
      const float dj = pr.ld[j];
      unsigned mask = 0;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = r0 + r;
        if (i >= pr.np || c <= i) continue;
        float d = pd[r][k];
        if (pr.metric == kEuclidean) {
          d = fmaxf(__fadd_rn(__fsub_rn(pr.sq[pr.al[i]], __fmul_rn(2.0f, d)), pr.sq[j]), 0.0f);
        } else if (pr.metric == kCosine) {
          d = __fsub_rn(1.0f, d);
        } else if (pr.metric == kDot) {
          d = -d;
        }
        if (__fmul_rn(pr.alpha, d) < dj) mask |= 1u << i;
      }
      if (mask) atomicOr(&pr.km[c], mask);
    }
  }
}

// Shared memory: the live candidates' distances, ids, squared norms and dead
// flags [P]; a round's live list and kill masks [P]; the kept ids [R]; scan
// sums; then the staged rows [stage, stride].
struct Layout {
  int ld, lid, sq, al, km, dead, adj, wsum, misc, rows, base_bytes;
};

inline int round16(int b) { return (b + 15) & ~15; }

__host__ inline Layout layout_of(int P, int R) {
  Layout y;
  int off = 0;
  y.ld = off; off += round16(4 * P);
  y.lid = off; off += round16(4 * P);
  y.sq = off; off += round16(4 * P);
  y.al = off; off += round16(4 * P);
  y.km = off; off += round16(4 * P);
  y.dead = off; off += round16(P);
  y.adj = off; off += round16(4 * R);
  y.wsum = off; off += round16(4 * kWarps);
  y.misc = off; off += round16(4 * 4);
  y.rows = off;
  y.base_bytes = off;
  return y;
}

__global__ void __launch_bounds__(kThreads, 2) vamana_robust_prune_kernel(
    const float* __restrict__ vectors, long long cap, int D, const float* __restrict__ cand_d,
    const int32_t* __restrict__ cand_i, const int32_t* __restrict__ self_ids, int P, int R, int r_stop,
    float alpha, int metric, Layout y, int stage, int32_t* __restrict__ out_adj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ld = reinterpret_cast<float*>(smem_raw + y.ld);
  int* lid = reinterpret_cast<int*>(smem_raw + y.lid);
  float* sq = reinterpret_cast<float*>(smem_raw + y.sq);
  int* al = reinterpret_cast<int*>(smem_raw + y.al);
  unsigned* km = reinterpret_cast<unsigned*>(smem_raw + y.km);
  unsigned char* dead = smem_raw + y.dead;
  int* adj = reinterpret_cast<int*>(smem_raw + y.adj);
  int* wsum = reinterpret_cast<int*>(smem_raw + y.wsum);
  int* misc = reinterpret_cast<int*>(smem_raw + y.misc);
  float* staged_rows = reinterpret_cast<float*>(smem_raw + y.rows);
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int self = self_ids[b];
  const float* gd = cand_d + (long long)b * P;
  const int32_t* gi = cand_i + (long long)b * P;
  // The live candidates, in pool order
  int n = 0;
  for (int base = 0; base < P; base += kThreads) {
    const int j = base + threadIdx.x;
    float d = 0.0f;
    int id = kNil;
    if (j < P) {
      d = gd[j];
      id = gi[j];
    }
    const bool live = j < P && id != kNil && id != self && isfinite(d);
    int tot;
    const int pre = block_scan(live, wsum, tot);
    if (live) {
      ld[n + pre] = d;
      lid[n + pre] = id;
    }
    n += tot;
  }
  const int stride = ((D + 3) & ~3) + 4;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(vectors) & 15) == 0;
  Rows rows;
  rows.staged = n <= stage;
  rows.staged_rows = staged_rows;
  rows.vectors = vectors;
  rows.stride = stride;
  rows.ids = lid;
  rows.cap = cap;
  rows.D = D;
  for (int i = threadIdx.x; i < n; i += kThreads) dead[i] = 0;
  __syncthreads();
  if (rows.staged) {
    // 16-byte pieces; the padding is zeros. With 16-byte rows every piece is
    // an asynchronous copy (cp.async), all of a thread's in flight at once
    const int C = stride >> 2, C4 = vec ? D / 4 : 0;
    for (long long e = threadIdx.x; e < (long long)n * C4; e += kThreads) {
      const int i = (int)(e / C4), c = (int)(e % C4);
      copy16(staged_rows + (long long)i * stride + 4 * c, rows.row<1>(i) + 4 * c);
    }
    for (long long e = threadIdx.x; e < (long long)n * (C - C4); e += kThreads) {
      const int i = (int)(e / (C - C4)), c = C4 + (int)(e % (C - C4));
      reinterpret_cast<float4*>(staged_rows + (long long)i * stride)[c] =
          vec ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : load4<2>(rows.row<2>(i), c, D);
    }
    copies_wait();
    __syncthreads();
  }
  if (metric == kEuclidean) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sq[i] = rows.staged ? self_dot<0>(rows.row<0>(i), D)
                          : (vec ? self_dot<1>(rows.row<1>(i), D) : self_dot<2>(rows.row<2>(i), D));
    }
  }
  Prune pr;
  pr.ld = ld;
  pr.lid = lid;
  pr.sq = sq;
  pr.al = al;
  pr.km = km;
  pr.metric = metric;
  pr.alpha = alpha;
  int count = 0, cursor = 0;
  while (count < r_stop) {
    // This round's live candidates at or after the cursor
    int m = 0;
    for (int base = cursor; base < n; base += kThreads) {
      const int i = base + threadIdx.x;
      const bool live = i < n && !dead[i];
      int tot;
      const int pre = block_scan(live, wsum, tot);
      if (live) al[m + pre] = i;
      m += tot;
    }
    if (m == 0) break;
    const int np = m < kPanel ? m : kPanel;
    for (int c = threadIdx.x; c < m; c += kThreads) km[c] = 0u;
    __syncthreads();
    pr.m = m;
    pr.np = np;
    if (rows.staged) panel_kills<0>(pr, rows);
    else if (vec) panel_kills<1>(pr, rows);
    else panel_kills<2>(pr, rows);
    __syncthreads();
    if (warp == 0) {
      // The greedy over the panel: lane l holds column l's mask
      const unsigned mine = lane < np ? km[lane] : 0u;
      unsigned alive = np == 32 ? 0xffffffffu : (1u << np) - 1u;
      unsigned kept = 0;
      int cnt = count;
      for (int i = 0; i < np; ++i) {
        if (!((alive >> i) & 1u)) continue;
        if (cnt >= r_stop) break;
        kept |= 1u << i;
        if (lane == 0 && cnt < R) adj[cnt] = lid[al[i]];  // past R, JAX's one_hot writes nothing
        ++cnt;
        alive &= ~__ballot_sync(0xffffffffu, lane > i && ((mine >> i) & 1u));
      }
      if (lane == 0) {
        misc[0] = cnt;
        misc[1] = (int)kept;
      }
    }
    __syncthreads();
    count = misc[0];
    const unsigned kept = (unsigned)misc[1];
    for (int c = threadIdx.x; c < m; c += kThreads)
      if (c < np || (km[c] & kept)) dead[al[c]] = 1;
    cursor = al[np - 1] + 1;
    __syncthreads();
  }
  int32_t* out = out_adj + (long long)b * R;
  for (int r = threadIdx.x; r < R; r += kThreads) out[r] = r < count ? adj[r] : kNil;  // count may pass R
}

struct Geometry {
  Layout y;
  int stage;  // live rows a pool may have and still be staged
  long long smem;
};

// The stage and the shared memory: as many padded rows as kStageBudget
// leaves after the block's other arrays, at most P.
Geometry pick_geometry(int P, int R, int D) {
  Geometry g;
  g.y = layout_of(P, R);
  const long long row_bytes = 4LL * (((D + 3) & ~3) + 4);
  long long stage = (kStageBudget - g.y.base_bytes) / row_bytes;
  if (stage < 0) stage = 0;
  g.stage = (int)(stage < P ? stage : P);
  g.smem = g.y.base_bytes + g.stage * row_bytes;
  return g;
}

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
  const Geometry g = pick_geometry(P, R, D);
  cudaError_t err = smem_opt_in((const void*)vamana_robust_prune_kernel, (size_t)g.smem);
  if (err != cudaSuccess) return (int)err;
  vamana_robust_prune_kernel<<<B, kThreads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), cap, D, static_cast<const float*>(cand_d),
      static_cast<const int32_t*>(cand_i), static_cast<const int32_t*>(self_ids), P, R, r_stop, alpha, metric,
      g.y, g.stage, static_cast<int32_t*>(out_adj));
  return (int)cudaGetLastError();
}

const char* semadb_vamana_prune_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
