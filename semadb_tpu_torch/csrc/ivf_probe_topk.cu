// K5: IVF probe selection, the score tile and the top-p in one pass, for Hopper.
//
// Replaces semadb_tpu/index/ivf.py:340 · _select_probes: an XLA contraction
// of the queries against every centroid ([B, D] x [C, D] -> [B, C], chunked
// over C past PROBE_CHUNK_BYTES) and a top-k over it (approx_max_k inside
// the chunks). The port's first version was the same chain in torch: a full
// f32 GEMM, the -2x and + |c|^2 passes and torch.topk over the [B, C] matrix.
//
//   q f32[B, D] x c f32[C, D] x csq f32[C]
//   -> out i32[B, p]: each query's p clusters of smallest score
//      csq[c] - 2 <q, c>, nearest first, equal scores by the lower id.
//      Euclidean passes |c|^2 as csq, dot and cosine pass zeros.
//
// What bounds it on the H100: operations. The products are 2·B·C·D flops
// (34.4 G at the bench cell, B = 4,096, C = 32,768, D = 128) against 19 MB
// of operands (the centroids and their norms stay in the 50 MB L2) and 0.4
// MB of ids out, ~1,800 flops a byte. The torch chain moved 4-5 GB a call
// through the [B, C] score matrix (512 MB at the cell) for 24 ids a query.
//
// What the design does about it:
//   - Float32 accuracy from the tensor cores: each product is three TF32
//     products, a_lo b_hi + a_hi b_lo + a_hi b_hi with x_hi = tf32(x) and
//     x_lo = tf32(x - x_hi), accumulated in f32: an error of f32's order
//     (the dropped a_lo b_lo is 2^-22 of the product).
//   - ivf_probe_topk_tile: a block takes BM queries (64 or 128) and one
//     slice of C. It streams the slice's centroids in tiles of BN = 128
//     rows, and the queries again for each tile, in chunks of 16 columns of
//     D through a cp.async ring. BM / 64 warpgroups each issue Hopper's
//     asynchronous wgmma m64n128k8 over 64 of the queries, their hi and lo
//     parts from registers and the centroids' from shared memory, split
//     once a chunk. The [B, C] matrix is never stored: each finished
//     [BM, BN] score tile goes to shared memory ([BN][BM + 4], conflict
//     free both ways), where a selecting warp group of BM threads, one a
//     query, keeps a max-heap of the query's p best keys, while the product
//     warpgroups compute the next tile; the tile changes hands through two
//     named barriers (full, free). A selecting thread first marks the
//     scores of 32 columns that reach its heap's root (the running p-th
//     best), then inserts only those. A key is (score, id) in one 64-bit
//     word, so equal scores order by the lower id. At the slice's end each
//     heap is sorted in place and written as the query's list of a partial
//     [B, slices, p]. A batch of up to 64 queries takes one tile of 64, its
//     empty rows zero-filled and masked.
//   - ivf_probe_topk_merge: a warp a query merges its sorted lists 32 keys
//     at a time into its top-p with a bitonic sort and merge across the
//     lanes, skipping every 32 that hold no key under its p-th best, and
//     writes the ids as int32.
// The wrapper picks BM from B and what the heaps take of shared memory, and
// the slices so that one wave of blocks fills the card (B = 1 takes up to 64
// slices of C); nothing is memset. Rows off the 16-byte grid (D % 4 != 0, as
// the fused index's D = 194) load element by element; ragged B, C and D are
// zero-filled in shared memory and masked.
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_optin.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;    // the merge kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;          // centroids a tile
constexpr int kBK = 16;           // columns of D a chunk
constexpr int kBKP = kBK + 4;     // a query chunk's row in shared memory: fragment loads conflict free
constexpr int kStages = 3;        // chunks in flight
constexpr int kMaxP = 256;
constexpr int kMaxSlices = 64;    // lists a query in the partial, one a slice
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kPad = 0xff800000ffffffffull;  // (+inf, id 2^32 - 1): after every real key

// (score, id) as one key whose unsigned order is the order of the scores,
// then of the ids (the float's bits made monotone; no NaN is ever keyed)
__device__ __forceinline__ u64 make_key(float s, int id) {
  const uint32_t u = __float_as_uint(s);
  return (u64)(u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u)) << 32 | (uint32_t)id;
}

__device__ __forceinline__ float key_score(u64 k) {
  const uint32_t u = (uint32_t)(k >> 32);
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ int key_id(u64 k) { return k == kPad ? -1 : (int)(uint32_t)k; }

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a < b ? b : a; }

// One key a lane -> the 32 keys ascending by lane (a bitonic sort).
__device__ __forceinline__ u64 sort32(u64 v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, v, j);
      v = (((lane & j) == 0) == ((lane & k) == 0)) ? kmin(v, o) : kmax(v, o);
    }
  }
  return v;
}

// t: an ascending list of R x 32 keys, key r * 32 + lane in t[r] of the
// lane; c: 32 ascending keys, one a lane. Leaves in t the R x 32 smallest of
// both, ascending: the list against c reversed is bitonic, then merged.
template <int R>
__device__ __forceinline__ void merge32(u64 (&t)[R], u64 c, int lane) {
  t[R - 1] = kmin(t[R - 1], __shfl_sync(kFull, c, 31 - lane));
#pragma unroll
  for (int jr = R / 2; jr > 0; jr >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & jr) == 0) {
        const u64 a = t[r], b = t[r | jr];
        t[r] = kmin(a, b);
        t[r | jr] = kmax(a, b);
      }
    }
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const u64 o = __shfl_xor_sync(kFull, t[r], j);
      t[r] = (lane & j) ? kmax(t[r], o) : kmin(t[r], o);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Named barriers: `n` threads, a multiple of 32, meet at barrier `id` (0 is
// __syncthreads'); arrive does not wait
__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x = hi + lo, both TF32 (the low 13 bits of their f32 patterns zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d (a warpgroup's 64 x 128 f32 tile; scale_d 0 overwrites it) += a (the
// warp's 16 rows x 8, mma.m16n8k8's A fragment) x b (8 x 128 in shared
// memory, by its descriptor)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], u64 desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Holds the compiler's reads and writes of d where they are: the wgmma's
// results land only by its wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
  asm volatile(""
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
               :
               : "memory");
}

// A K-major shared-memory operand without swizzle: core matrices of 8 rows
// x 16 bytes, 128 bytes apart along K and 512 (a chunk's four) along N
__device__ __forceinline__ u64 wgmma_desc(const void* p) {
  return (u64)((smem_u32(p) & 0x3ffff) >> 4) | (u64)(128 >> 4) << 16 | (u64)(512 >> 4) << 32;
}

// Element (n, k) of a chunk's centroid rows in that layout
__device__ __forceinline__ int core_at(int n, int k) { return (((n >> 3) * 4 + (k >> 2)) << 5) + ((n & 7) << 2) + (k & 3); }

// Columns k0 .. k0 + kBK of rows row0 .. row0 + ROWS of src [*, D] into dst,
// by the block's first NT threads; rows from row_end on and columns from D
// on read as 0. kCore puts them in the wgmma layout (core_at), else rows of
// kBKP floats.
template <int ROWS, int NT, bool kVec, bool kCore>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0, int row_end, int k0,
                                          int D) {
  constexpr int kPer = kVec ? 4 : 1;  // floats a copy
  constexpr int kUnits = ROWS * (kBK / kPer);
#pragma unroll
  for (int i = 0; i < (kUnits + NT - 1) / NT; ++i) {
    const int v = i * NT + threadIdx.x;
    if (kUnits % NT == 0 || v < kUnits) {
      const int r = v / (kBK / kPer), cc = (v % (kBK / kPer)) * kPer;
      const int gr = row0 + r, gk = k0 + cc;
      const bool ok = gr < row_end && gk < D;
      const float* s = ok ? src + (size_t)gr * D + gk : src;
      float* d = dst + (kCore ? core_at(r, cc) : r * kBKP + cc);
      if (kVec) {
        cp_async16(smem_u32(d), s, ok);
      } else {
        cp_async4(smem_u32(d), s, ok);
      }
    }
  }
}

// The heaps: entry `slot` of heap h lies at [slot * nh + h], so the lanes of
// a warp (consecutive heaps) never share a bank. Max-heaps of keys.
__device__ __forceinline__ void sift_down(u64* hk, int nh, int h, int n, int i, u64 k) {
  while (true) {
    int ch = 2 * i + 1;
    if (ch >= n) break;
    u64 ck = hk[ch * nh + h];
    if (ch + 1 < n) {
      const u64 rk = hk[(ch + 1) * nh + h];
      if (ck < rk) {
        ++ch;
        ck = rk;
      }
    }
    if (k >= ck) break;
    hk[i * nh + h] = ck;
    i = ch;
  }
  hk[i * nh + h] = k;
}

// k into heap h of cnt keys (at most p): appended while the heap fills,
// else in place of the root when below it. top is the root once the heap
// is full (kPad before), top_s its score, the bound a score must reach.
__device__ __forceinline__ void heap_insert(u64* hk, int nh, int h, int p, int& cnt, u64& top, float& top_s, u64 k) {
  if (cnt < p) {
    int i = cnt++;
    while (i > 0) {
      const int par = (i - 1) >> 1;
      const u64 pk = hk[par * nh + h];
      if (pk >= k) break;
      hk[i * nh + h] = pk;
      i = par;
    }
    hk[i * nh + h] = k;
  } else {
    if (k >= top) return;
    sift_down(hk, nh, h, p, 0, k);
  }
  if (cnt == p) {
    top = hk[h];
    top_s = key_score(top);
  }
}

// The tile kernel's shared memory: the ring (a query chunk, a centroid
// chunk's hi and lo parts), the score tile, the heaps
__host__ __device__ constexpr size_t tile_smem_bytes(int bm, int p) {
  return (size_t)kStages * (bm * kBKP + kBN * 2 * kBK) * sizeof(float) + (size_t)kBN * (bm + 4) * sizeof(float) +
         (size_t)bm * p * sizeof(u64);
}

// The threads of a tile kernel's block: BM / 64 product warpgroups (2 BM
// threads), then the selecting warps, one thread a query
__host__ __device__ constexpr int tile_threads(int bm) { return 3 * bm; }

// Grid (ceil(B / BM), slices). Slice y covers clusters [y * slice_tiles *
// kBN, ...) up to C; the selecting thread of row r keeps query q0 + r's
// heap over the slice and writes it as the query's list y.
template <int BM, bool kVec>
__global__ void __launch_bounds__(3 * BM, 1)
    ivf_probe_topk_tile(const float* __restrict__ q, const float* __restrict__ c, const float* __restrict__ csq,
                        int B, int C, int D, int p, int slice_tiles, u64* __restrict__ part) {
  constexpr int kProd = 2 * BM;               // the product warpgroups' threads, 64 queries each
  constexpr int A_FLOATS = BM * kBKP;         // a stage's query chunk
  constexpr int B_FLOATS = kBN * 2 * kBK;     // its centroid chunk, hi and lo
  constexpr int TSTR = BM + 4;                // a column of the score tile
  extern __shared__ __align__(128) float smem[];
  float* Bs = smem;                     // [kStages][B_FLOATS]: first, 128-byte aligned for the descriptors
  float* As = Bs + kStages * B_FLOATS;  // [kStages][BM][kBKP]
  float* Ts = As + kStages * A_FLOATS;  // [kBN][TSTR]
  u64* Hk = reinterpret_cast<u64*>(Ts + kBN * TSTR);  // [p][BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int c_begin = blockIdx.y * slice_tiles * kBN;
  const int c_end = min(C, c_begin + slice_tiles * kBN);
  const int tiles = (c_end - c_begin + kBN - 1) / kBN;
  const int KT = (D + kBK - 1) / kBK;
  const int chunks = tiles * KT;
  // Ts changes hands: full once the product warpgroups wrote a tile, free
  // once the selecting warps are done with it
  constexpr int kTsFull = 2, kTsFree = 3, kTsThreads = kProd + BM;

  if (tid >= kProd) {
    // A selecting thread: its query's columns of each tile into its heap.
    // The scores of up to 32 columns that reach the heap's root are marked,
    // then inserted.
    const int row = tid - kProd;
    const bool owner = q0 + row < B;
    int cnt = 0;
    u64 top = kPad;
    float top_s = __int_as_float(0x7f800000);
    for (int tile = 0; tile < tiles; ++tile) {
      bar_sync(kTsFull, kTsThreads);
      const int n0 = c_begin + tile * kBN, hi = min(kBN, c_end - n0);
      for (int b0 = 0; owner && b0 < hi; b0 += 32) {
        const int m = min(32, hi - b0);
        uint32_t mark = 0;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          if (j < m && Ts[(b0 + j) * TSTR + row] <= top_s) mark |= 1u << j;
        }
        while (mark) {
          const int j = __ffs(mark) - 1;
          mark &= mark - 1;
          heap_insert(Hk, BM, row, p, cnt, top, top_s, make_key(Ts[(b0 + j) * TSTR + row], n0 + b0 + j));
        }
      }
      if (tile + 1 < tiles) bar_arrive(kTsFree, kTsThreads);
    }
    if (!owner) return;
    // The heap sorted in place, ascending over its first cnt places, out as
    // the query's list
    for (int n = cnt - 1; n > 0; --n) {
      const u64 mk = Hk[row];
      sift_down(Hk, BM, row, n, 0, Hk[n * BM + row]);
      Hk[n * BM + row] = mk;
    }
    u64* out = part + ((size_t)(q0 + row) * gridDim.y + blockIdx.y) * p;
    for (int j = 0; j < p; ++j) out[j] = j < cnt ? Hk[j * BM + row] : kPad;
    return;
  }

  auto load_chunk = [&](int gc) {
    const int st = gc % kStages, tile = gc / KT, k0 = (gc % KT) * kBK;
    load_rows<BM, kProd, kVec, false>(As + st * A_FLOATS, q, q0, B, k0, D);
    load_rows<kBN, kProd, kVec, true>(Bs + st * B_FLOATS, c, c_begin + tile * kBN, c_end, k0, D);
  };

  // The warpgroup's accumulators: acc[j * 4 + i], n8 block j
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load_chunk(s);
    cp_async_commit();
  }
  for (int gc = 0; gc < chunks; ++gc) {
    cp_async_wait<kStages - 2>();
    bar_sync(1, kProd);  // chunk gc has landed; every warp is done with chunk gc - 1's stage
    if (gc + kStages - 1 < chunks) load_chunk(gc + kStages - 1);
    cp_async_commit();
    const float* Ast = As + (gc % kStages) * A_FLOATS;
    float* Bst = Bs + (gc % kStages) * B_FLOATS;
    // The centroids' hi parts in place, their lo parts beside them
    for (int e = tid; e < kBN * kBK; e += kProd) {
      const float x = Bst[e];
      const uint32_t hi = tf32(x);
      Bst[e] = __uint_as_float(hi);
      Bst[kBN * kBK + e] = __uint_as_float(tf32(x - __uint_as_float(hi)));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, kProd);
    const int m = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // the first of this thread's rows
    const float* a0 = Ast + m * kBKP + t;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* a = a0 + ks * 8;
      split_tf32(a[0], ah[ks][0], al[ks][0]);
      split_tf32(a[8 * kBKP], ah[ks][1], al[ks][1]);
      split_tf32(a[4], ah[ks][2], al[ks][2]);
      split_tf32(a[8 * kBKP + 4], ah[ks][3], al[ks][3]);
    }
    const int first = gc % KT == 0 ? 0 : 1;  // a tile's first chunk overwrites the accumulators
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const u64 dh = wgmma_desc(Bst + ks * 64), dl = wgmma_desc(Bst + kBN * kBK + ks * 64);
      wgmma_tf32(acc, al[ks], dh, ks == 0 ? first : 1);
      wgmma_tf32(acc, ah[ks], dl, 1);
      wgmma_tf32(acc, ah[ks], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (gc % KT != KT - 1) continue;
    // The tile's scores are whole: csq - 2 acc into Ts, once the selecting
    // warps are done with the previous tile
    const int n0 = c_begin + (gc / KT) * kBN;
    if (gc >= KT) bar_sync(kTsFree, kTsThreads);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = j * 8 + 2 * t + i;
        const float cs = n0 + n < c_end ? __ldg(csq + n0 + n) : 0.f;
        Ts[n * TSTR + m] = cs - 2.f * acc[j * 4 + i];
        Ts[n * TSTR + m + 8] = cs - 2.f * acc[j * 4 + 2 + i];
      }
    }
    bar_arrive(kTsFull, kTsThreads);
  }
  cp_async_wait<0>();
}

// A warp a query: the query's `lists` sorted lists of p keys -> its p
// smallest keys' ids, ascending.
template <int R>
__global__ void __launch_bounds__(kThreads)
    ivf_probe_topk_merge(const u64* __restrict__ part, int B, int lists, int p, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int n = lists * p;
  const u64* src = part + (size_t)b * n;
  u64 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = kPad;
  u64 kth = kPad;  // the list's p-th key
  for (int i0 = 0; i0 < n; i0 += 4 * 32) {
    u64 k[4];  // four loads in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = i0 + u * 32 + lane < n ? src[i0 + u * 32 + lane] : kPad;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const u64 x = k[u] < kth ? k[u] : kPad;
      if (__ballot_sync(kFull, x != kPad) == 0) continue;
      merge32<R>(t, sort32(x, lane), lane);
      u64 kp = t[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        if (r == (p - 1) >> 5) kp = t[r];
      }
      kth = __shfl_sync(kFull, kp, (p - 1) & 31);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = i * 32 + lane;
    if (e < p) out[(size_t)b * p + e] = key_id(t[i]);
  }
}

template <int BM, bool kVec>
cudaError_t launch_tile(const float* q, const float* c, const float* csq, int B, int C, int D, int p, int slices,
                        int slice_tiles, u64* part, cudaStream_t s) {
  const size_t smem = tile_smem_bytes(BM, p);
  const cudaError_t e = smem_opt_in((const void*)ivf_probe_topk_tile<BM, kVec>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + BM - 1) / BM, slices);
  ivf_probe_topk_tile<BM, kVec><<<grid, tile_threads(BM), smem, s>>>(q, c, csq, B, C, D, p, slice_tiles, part);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_tile_bm(int bm, const float* q, const float* c, const float* csq, int B, int C, int D, int p,
                           int slices, int slice_tiles, u64* part, cudaStream_t s) {
  return bm == 64 ? launch_tile<64, kVec>(q, c, csq, B, C, D, p, slices, slice_tiles, part, s)
                  : launch_tile<128, kVec>(q, c, csq, B, C, D, p, slices, slice_tiles, part, s);
}

cudaError_t launch_merge(const u64* part, int B, int lists, int p, int* out, cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  if (p <= 32) {
    ivf_probe_topk_merge<1><<<blocks, kThreads, 0, s>>>(part, B, lists, p, out);
  } else if (p <= 64) {
    ivf_probe_topk_merge<2><<<blocks, kThreads, 0, s>>>(part, B, lists, p, out);
  } else if (p <= 128) {
    ivf_probe_topk_merge<4><<<blocks, kThreads, 0, s>>>(part, B, lists, p, out);
  } else {
    ivf_probe_topk_merge<8><<<blocks, kThreads, 0, s>>>(part, B, lists, p, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers are device pointers. q f32[B, D], c f32[C, D], csq f32[C];
// part u64[B, slices, p] is scratch that the kernels write whole; out
// i32[B, p]. bm in {64, 128}; the slices of slice_tiles x 128 clusters
// cover C, none empty, at most 64 of them; the tile kernel's shared memory
// (tile_smem_bytes) within what the card allows. Returns the first CUDA
// error of the two launches (0 on success). Launches on `stream`; does not
// synchronise.
int semadb_ivf_probe_topk(const void* q, const void* c, const void* csq, int B, int C, int D, int p, int bm,
                          int slices, int slice_tiles, void* part, void* out, void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || p <= 0 || p > kMaxP || p > C || (bm != 64 && bm != 128) || slices <= 0 ||
      slices > kMaxSlices || slice_tiles <= 0 || (long long)(slices - 1) * slice_tiles * kBN >= C ||
      (long long)slices * slice_tiles * kBN < C || q == nullptr || c == nullptr || csq == nullptr ||
      part == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(c);
  const float* sf = static_cast<const float*>(csq);
  u64* pk = static_cast<u64*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec ? launch_tile_bm<true>(bm, qf, cf, sf, B, C, D, p, slices, slice_tiles, pk, s)
                            : launch_tile_bm<false>(bm, qf, cf, sf, B, C, D, p, slices, slice_tiles, pk, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_merge(pk, B, slices, p, static_cast<int*>(out), s);
}

const char* semadb_ivf_probe_topk_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }

}  // extern "C"
