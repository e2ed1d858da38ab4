// K4: IVF exact rerank of the coarse pool, for Hopper.
//
// Replaces the XLA program of semadb_tpu/index/ivf.py · _ivf_query that
// deduplicates and reranks the pool (:510-515: dedup_by_id, when points have
// SOAR copies; :517-543: vectors[pool] gathered as [B, rr, D] (or in chunks
// of 64), the exact f32 metric, top_k, (inf, -1) for empty slots).
//
//   vectors f32[cap, D] x queries f32[B, D] x pool i32[B, rr]
//   x coarse f32[B, rr] -> the k smallest exact distances, ascending by
//      (d, id), as out_d f32[B, k] and out_i i32[B, k]; with dedup, an id
//      that fills several slots of a pool row is returned once
//
// A pool slot is empty when its coarse score is not finite or its id lies
// outside [0, cap) (the JAX program clips such ids and masks -1; every id the
// engine hands over is in range). Metrics as the engine defines them:
// euclidean sum (x - q)^2 (taken directly, not by the norm expansion), dot
// -sum x q, cosine 1 - sum x q. Empty and unfilled places come out (inf, -1);
// k may exceed rr. rr <= 2048, D <= 4096.
//
// What bounds it on the H100: bytes. D multiply-adds per 4 D bytes of
// gathered row. The least traffic is each distinct live pool row once, plus
// the queries, the pool, the coarse scores and the output: 69.0 MB a
// 4,096-query batch at the 1M x 128 cell (125,901 distinct rows), 0.0206 ms
// at 3.35 TB/s.
//
// What the design does about it. To cover ~1 us of memory latency at
// 3.35 TB/s the card needs ~3.3 MB in flight, ~25 KB an SM. The first design
// (one block per query, each lane one 16-byte load of a row and a shuffle
// reduction before the next) kept 8 rows, 4 KB, in flight a block and waited
// out one latency per 8 rows. Now:
//   - a block takes G queries (G = 256 / pow2(rr), at most one a warp, fewer
//     when D is large or the batch would not fill the SMs twice; 1 when
//     k > 32), so the fixed costs of a block are paid once per G queries;
//   - each thread loads its first pool slot while shared memory is set up.
//     Before any row is read, each slot's id is checked (empty slots drop)
//     and, with dedup, put into an open-addressing hash table in shared
//     memory (atomicCAS, linear probing, twice the pool's size): a later
//     copy of an id drops too. JAX's dedup_by_id only empties the other
//     copies of an id, whose exact distance is the kept copy's (one row), so
//     which copy stays is free. The live slots are compacted into one list
//     (warp ballots, one shared atomic a warp);
//   - bulk route (D % 4 == 0 and a 16-byte-aligned base, so every row is one
//     contiguous run of 4 D bytes on the 16-byte grid): the Tensor Memory
//     Accelerator copies the rows into shared memory. The list is cut into
//     stages of R rows, each stage buffer with an mbarrier. Warp 0's lanes
//     issue one cp.async.bulk per row of a stage, after lane 0 arms the
//     barrier with the stage's bytes; every warp waits on the barrier's
//     phase parity ((stage / S) & 1), scores rows out of shared memory (a
//     team of lanes a row, 16-byte shared loads, f32 FFMA, a shuffle
//     reduction), and after a __syncthreads warp 0 refills that buffer with
//     the stage S ahead. No register holds a load in flight. A stage always
//     holds at least one live row (the list is compacted), so every armed
//     barrier completes;
//   - the stages follow the grid. With several blocks an SM (B = 4,096 at
//     the cell: G = 4, 1,024 blocks) a block's time is a chain of
//     latencies (pool, then rows, then the selection), so what counts is how
//     many blocks an SM holds: S = 2 stages of 16 KB (32 rows of D = 128, 2
//     of D = 1536), ~41 KB of shared memory a block at the cell, five blocks
//     and up to 160 KB in flight an SM (four stages, or 32 KB stages, held
//     fewer blocks and were slower on the card). With at most one block an
//     SM (small batches; B = 1, every HTTP search) one block's bytes in
//     flight set the time: S = 4 stages of 48 KB;
//   - element route (D % 4 != 0, or a base off the 16-byte grid, where a
//     bulk copy cannot go): the same blocks, lists and selection, with the
//     rows read straight from device memory by a team of lanes, one element
//     a load (the first design's loads);
//   - selection: for k <= 32 one warp per query keeps its running 32
//     smallest (d, id) one per lane, sorted across the lanes. A chunk of 32
//     candidates is skipped when none beats the running k-th (one ballot);
//     else it is sorted by a 15-step shuffle network and merged by the
//     bitonic half-cleaner (the smaller of running[i] and chunk[31 - i], then
//     5 steps). No __syncthreads. For k > 32, the block's bitonic sort of the
//     pow2(rr) pairs in shared memory, as before;
//   - no [B, rr, D] intermediate exists (6.4 GB at 4,096 queries x rr = 256
//     of 1536-d rows in the unchunked JAX form).
// What the bound does not see: a query reads its own pool's rows, so a row
// in several queries' pools is read once for each (from L2 when it is still
// there). At the projected shape with random pools (1M slots over 400,000
// rows) that is 2.8x the distinct bytes, and the kernel moves them near the
// memory rate; only a row-major order (each distinct row read once and
// scored against every query that holds it, as K3 does for clusters) would
// approach the bound there.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include "ivf_common.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int kEuclidean = 0, kDot = 1, kCosine = 2;
constexpr int kMaxPool = 2048;
constexpr int kMaxD = 4096;
constexpr int kBlock = 256;  // threads a block
constexpr int kWarps = kBlock / 32;
// Stages: when the grid leaves SMs with several blocks, kStagesMany of
// kStageBytesMany each, so that many blocks share an SM and their latency
// chains overlap; when it fills at most one block an SM (small batches),
// kStagesFew of 48 KB, so one block keeps ~150 KB in flight.
constexpr int kStagesMany = 2, kStageBytesMany = 16384;
constexpr int kStagesFew = 4, kStageBytesFew = 49152;
constexpr int kMaxStages = 4;
constexpr int kMaxStageRows = 64;
constexpr size_t kSmemCap = 227 * 1024;
constexpr int kMaxGroup = kWarps;  // queries a block: at most one a warp for the selection
constexpr int kWarpK = 32;    // the warp selection's k

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One row of `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <bool kSqDiff>
__device__ __forceinline__ float term(float x, float q) {
  if (kSqDiff) {
    const float t = x - q;
    return t * t;
  }
  return x * q;
}

template <int kMetric>
__device__ __forceinline__ float finish(float s) {
  return kMetric == kEuclidean ? s : kMetric == kCosine ? 1.f - s : -s;
}

// (a_d, a_i) < (b_d, b_i), by distance and then id
__device__ __forceinline__ bool pair_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// One compare-exchange step of a shuffle network: this lane keeps the
// smaller pair of itself and lane ^ j when keep_min, else the larger.
__device__ __forceinline__ void exchange(float& d, int& id, int j, bool keep_min) {
  const float od = __shfl_xor_sync(0xffffffffu, d, j);
  const int oi = __shfl_xor_sync(0xffffffffu, id, j);
  const bool other_less = pair_less(od, oi, d, id);
  if (other_less == keep_min) {
    d = od;
    id = oi;
  }
}

// The k (<= 32) smallest (d, id) of n candidates in shared memory, one warp:
// lane i ends holding the i-th smallest ((inf, INT_MAX) past the live ones).
__device__ void warp_select(const float* dist, const int* ids, int n, int k, float& bd, int& bi) {
  const int lane = threadIdx.x & 31;
  bd = __int_as_float(0x7f800000);
  bi = INT_MAX;
  for (int c = 0; c < n; c += 32) {
    const int j = c + lane;
    float d = j < n ? dist[j] : __int_as_float(0x7f800000);
    int id = j < n ? ids[j] : INT_MAX;
    const float td = __shfl_sync(0xffffffffu, bd, k - 1);
    const int ti = __shfl_sync(0xffffffffu, bi, k - 1);
    if (!__any_sync(0xffffffffu, pair_less(d, id, td, ti))) continue;
    for (int size = 2; size <= 32; size <<= 1) {  // sort the chunk ascending across the lanes
      for (int j2 = size >> 1; j2 > 0; j2 >>= 1) {
        exchange(d, id, j2, ((lane & j2) == 0) == ((lane & size) == 0));
      }
    }
    // the 32 smallest of both, a bitonic sequence, then sorted
    const float rd = __shfl_sync(0xffffffffu, d, 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, id, 31 - lane);
    if (pair_less(rd, ri, bd, bi)) {
      bd = rd;
      bi = ri;
    }
    for (int j2 = 16; j2 > 0; j2 >>= 1) exchange(bd, bi, j2, (lane & j2) == 0);
  }
}

struct Layout {
  int G, P, S, R, dpad, row_bytes;
  size_t stage_off, q_off, dist_off, ids_off, table_off, list_off, smem;
};

// The shared memory of a block: kMaxStages barriers, `stages` stage
// buffers (bulk route), G query rows, G x P (distance, id) pairs, G x 2P
// hash slots (with dedup), the live list of G x rr (slot, id) and its
// counter. A stage holds up to `stage_bytes` of rows (at least one row, at
// most kMaxStageRows), within what the rest leaves of kSmemCap.
Layout make_layout(int G, int rr, int D, bool bulk, bool dedup, int stages, int stage_bytes) {
  Layout L;
  L.G = G;
  L.P = ivf::pow2_at_least(rr);
  L.S = stages;
  L.dpad = (D + 7) & ~7;
  L.row_bytes = 4 * D;
  const size_t bars = 16 * ((kMaxStages * 8 + 15) / 16);
  const size_t rest = (size_t)G * L.dpad * 4 + (size_t)G * L.P * 8 + (dedup ? (size_t)G * 2 * L.P * 4 : 0) +
                      (size_t)G * rr * 8 + 16;
  const int room = (int)((kSmemCap - bars - rest) / stages);
  const int rows = (stage_bytes < room ? stage_bytes : room) / L.row_bytes;
  L.R = bulk ? (rows < 1 ? 1 : rows > kMaxStageRows ? kMaxStageRows : rows) : 0;
  size_t off = bars;
  L.stage_off = off;
  off += bulk ? (size_t)stages * L.R * L.row_bytes : 0;
  L.q_off = off;
  off += (size_t)G * L.dpad * 4;
  L.dist_off = off;
  off += (size_t)G * L.P * 4;
  L.ids_off = off;
  off += (size_t)G * L.P * 4;
  L.table_off = off;
  off += dedup ? (size_t)G * 2 * L.P * 4 : 0;
  L.list_off = off;
  off += (size_t)G * rr * 8 + 16;
  L.smem = off;
  return L;
}

template <bool kBulk, int kMetric>
__global__ void __launch_bounds__(kBlock)
rerank_kernel(const float* __restrict__ vectors, long long cap, int D,
              const float* __restrict__ queries, const int32_t* __restrict__ pool,
              const float* __restrict__ coarse, int B, int rr, int k, int dedup, Layout lay,
              float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + lay.stage_off;
  float* q = reinterpret_cast<float*>(smem + lay.q_off);
  float* dist = reinterpret_cast<float*>(smem + lay.dist_off);
  int* dids = reinterpret_cast<int*>(smem + lay.ids_off);
  int* table = reinterpret_cast<int*>(smem + lay.table_off);
  int* list_slot = reinterpret_cast<int*>(smem + lay.list_off);
  int* list_id = list_slot + lay.G * rr;
  int* count = list_id + lay.G * rr;
  const float inf = __int_as_float(0x7f800000);
  const int G = lay.G, P = lay.P, dpad = lay.dpad;
  const long long b0 = (long long)blockIdx.x * G;
  const int ng = (int)min((long long)G, B - b0);  // queries of this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // This thread's first pool slot, loaded while shared memory is set up
  const int slots = ng * rr;
  int first = -1;
  if (threadIdx.x < slots) {
    const long long o = b0 * rr + threadIdx.x;  // slot j of query g is (b0 + g) * rr + j
    first = __ldg(pool + o);
    if (first < 0 || first >= cap || !isfinite(__ldg(coarse + o))) first = -1;
  }
  if (kBulk && threadIdx.x == 0) {
    for (int s = 0; s < lay.S; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == 0) *count = 0;
  for (int e = threadIdx.x; e < ng * dpad; e += blockDim.x) {
    const int g = e / dpad, c = e - g * dpad;
    q[e] = c < D ? queries[(b0 + g) * D + c] : 0.f;
  }
  for (int e = threadIdx.x; e < ng * P; e += blockDim.x) {
    dist[e] = inf;
    dids[e] = INT_MAX;
  }
  if (dedup) {
    for (int e = threadIdx.x; e < ng * 2 * P; e += blockDim.x) table[e] = -1;
  }
  __syncthreads();

  // Live slots into the list: empty slots and later copies drop
  for (int t0 = 0; t0 < slots; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int id = -1, g = 0, j = 0;
    if (t < slots) {
      g = t / rr;
      j = t - g * rr;
      if (t0 == 0) {
        id = first;
      } else {
        id = __ldg(pool + (b0 + g) * rr + j);
        if (id < 0 || id >= cap || !isfinite(__ldg(coarse + (b0 + g) * rr + j))) id = -1;
      }
      if (dedup && id != -1) {
        int* tab = table + g * 2 * P;
        const unsigned tmask = 2u * P - 1u;
        for (unsigned h = ((unsigned)id * 2654435761u) & tmask;; h = (h + 1) & tmask) {
          const int held = atomicCAS(tab + h, -1, id);
          if (held == -1) break;  // the first copy: it stays
          if (held == id) {
            id = -1;  // a later copy
            break;
          }
        }
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, id != -1);
    int base = 0;
    if (lane == 0 && live) base = atomicAdd(count, __popc(live));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (id != -1) {
      const int pos = base + __popc(live & ((1u << lane) - 1u));
      list_slot[pos] = g * P + j;
      list_id[pos] = id;
    }
  }
  __syncthreads();
  const int n_live = *count;

  // Score the live rows: a team of ts lanes a row
  const int units = kBulk ? D / 4 : D;
  const int ts = ivf::team_size(units);
  const int tl = lane & (ts - 1), team = lane / ts;
  const int teams_per_warp = 32 / ts;
  const int teams = kWarps * teams_per_warp;
  if (kBulk) {
    const int R = lay.R;
    const uint32_t row_bytes = lay.row_bytes;
    const int n_stages = (n_live + R - 1) / R;
    auto issue = [&](int s) {  // warp 0: arm stage s's barrier and copy its rows
      const int buf = s % lay.S;
      const int rows = min(R, n_live - s * R);
      if (lane == 0) mbar_arrive_expect(bars + buf, rows * row_bytes);
      __syncwarp();
      for (int r = lane; r < rows; r += 32) {
        bulk_copy(stages + (size_t)(buf * R + r) * row_bytes,
                  vectors + (long long)list_id[s * R + r] * D, row_bytes, bars + buf);
      }
    };
    if (warp == 0) {
      for (int s = 0; s < lay.S && s < n_stages; ++s) issue(s);
    }
    for (int s = 0; s < n_stages; ++s) {
      const int buf = s % lay.S;
      const int rows = min(R, n_live - s * R);
      mbar_wait(bars + buf, (uint32_t)((s / lay.S) & 1));
      const float* rows_base = reinterpret_cast<const float*>(stages + (size_t)buf * R * row_bytes);
      for (int r0 = warp * teams_per_warp; r0 < rows; r0 += teams) {
        const int r = r0 + team;
        float part = 0.f;
        int slot = 0;
        if (r < rows) {
          slot = list_slot[s * R + r];
          const float4* x4 = reinterpret_cast<const float4*>(rows_base + (size_t)r * D);
          const float4* q4 = reinterpret_cast<const float4*>(q + (slot / P) * dpad);
          for (int u = tl; u < units; u += ts) {
            const float4 v = x4[u], a = q4[u];
            part += term<kMetric == kEuclidean>(v.x, a.x) + term<kMetric == kEuclidean>(v.y, a.y) +
                    term<kMetric == kEuclidean>(v.z, a.z) + term<kMetric == kEuclidean>(v.w, a.w);
          }
        }
        const float sum = ivf::team_sum(part, ts);
        if (r < rows && tl == 0) {
          dist[slot] = finish<kMetric>(sum);
          dids[slot] = list_id[s * R + r];
        }
      }
      __syncthreads();  // every warp is done with this buffer
      if (warp == 0 && s + lay.S < n_stages) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(s + lay.S);
      }
    }
  } else {
    for (int r0 = warp * teams_per_warp; r0 < n_live; r0 += teams) {
      const int r = r0 + team;
      float part = 0.f;
      int slot = 0;
      if (r < n_live) {
        slot = list_slot[r];
        const float* row = vectors + (long long)list_id[r] * D;
        const float* qg = q + (slot / P) * dpad;
        for (int e = tl; e < D; e += ts) part += term<kMetric == kEuclidean>(__ldg(row + e), qg[e]);
      }
      const float sum = ivf::team_sum(part, ts);
      if (r < n_live && tl == 0) {
        dist[slot] = finish<kMetric>(sum);
        dids[slot] = list_id[r];
      }
    }
    __syncthreads();
  }

  if (k <= kWarpK) {
    if (warp < ng) {
      float bd;
      int bi;
      warp_select(dist + warp * P, dids + warp * P, rr, k, bd, bi);
      if (lane < k) {
        const long long o = (b0 + warp) * k + lane;
        const bool ok = isfinite(bd);
        out_d[o] = ok ? bd : inf;
        out_i[o] = ok ? bi : -1;
      }
    }
    return;
  }
  // k > 32: one query a block (G = 1); the block's bitonic sort
  ivf::bitonic_sort(dist, dids, P);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const bool ok = i < P && isfinite(dist[i]);
    out_d[b0 * k + i] = ok ? dist[i] : inf;
    out_i[b0 * k + i] = ok ? dids[i] : -1;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) {
      n = 132;
    }
  }
  return n;
}

// Queries a block: enough rows to pay a block's fixed costs once for
// several queries, the query rows within 16 KB, and at least two blocks an
// SM when the batch allows it.
int group_size(int B, int rr, int D, int k) {
  if (k > kWarpK) return 1;
  int g = 256 / ivf::pow2_at_least(rr);
  g = g < 4096 / D ? g : 4096 / D;
  const int fill = B / (2 * sm_count());
  g = g < fill ? g : fill;
  return g < 1 ? 1 : g > kMaxGroup ? kMaxGroup : g;
}

template <bool kBulk, int kMetric>
cudaError_t launch(const float* vectors, long long cap, int D, const float* queries,
                   const int32_t* pool, const float* coarse, int B, int rr, int k, int dedup,
                   float* out_d, int32_t* out_i, cudaStream_t stream) {
  const int G = group_size(B, rr, D, k);
  const unsigned grid = (unsigned)((B + G - 1) / G);
  const bool few = (int)grid <= sm_count();
  const Layout lay = make_layout(G, rr, D, kBulk, dedup != 0, few ? kStagesFew : kStagesMany,
                                 few ? kStageBytesFew : kStageBytesMany);
  cudaError_t e = smem_opt_in((const void*)rerank_kernel<kBulk, kMetric>, lay.smem);
  if (e != cudaSuccess) return e;
  rerank_kernel<kBulk, kMetric><<<grid, kBlock, lay.smem, stream>>>(
      vectors, cap, D, queries, pool, coarse, B, rr, k, dedup, lay, out_d, out_i);
  return cudaGetLastError();
}

template <bool kBulk>
cudaError_t by_metric(int metric, const float* vectors, long long cap, int D, const float* queries,
                      const int32_t* pool, const float* coarse, int B, int rr, int k, int dedup,
                      float* out_d, int32_t* out_i, cudaStream_t stream) {
  switch (metric) {
    case kEuclidean:
      return launch<kBulk, kEuclidean>(vectors, cap, D, queries, pool, coarse, B, rr, k, dedup, out_d, out_i, stream);
    case kDot:
      return launch<kBulk, kDot>(vectors, cap, D, queries, pool, coarse, B, rr, k, dedup, out_d, out_i, stream);
    case kCosine:
      return launch<kBulk, kCosine>(vectors, cap, D, queries, pool, coarse, B, rr, k, dedup, out_d, out_i, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Rows of `vectors` (D floats each) go by bulk copy when each is a run of
// whole 16-byte units on the 16-byte grid; else by the element route.
bool bulk_route(const void* vectors, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
}

}  // namespace

extern "C" {

// Pointers are device pointers. metric: 0 euclidean, 1 dot, 2 cosine;
// dedup != 0 returns each id of a pool row once. Returns cudaGetLastError()
// after the launch (0 on success). Launches on `stream`; does not synchronise.
int semadb_ivf_exact_rerank(const void* vectors, long long cap, int D, const void* queries,
                            const void* pool, const void* coarse, int B, int rr, int k, int metric,
                            int dedup, void* out_d, void* out_i, void* stream) {
  if (cap <= 0 || D <= 0 || D > kMaxD || B <= 0 || rr <= 0 || rr > kMaxPool || k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* v = static_cast<const float*>(vectors);
  const float* q = static_cast<const float*>(queries);
  const int32_t* pl = static_cast<const int32_t*>(pool);
  const float* c = static_cast<const float*>(coarse);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bulk_route(vectors, D)
                   ? by_metric<true>(metric, v, cap, D, q, pl, c, B, rr, k, dedup, od, oi, s)
                   : by_metric<false>(metric, v, cap, D, q, pl, c, B, rr, k, dedup, od, oi, s));
}

const char* semadb_ivf_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
