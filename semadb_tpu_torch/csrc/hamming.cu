// All-pairs hamming / jaccard distance over bit-packed codes, for Hopper.
//
// Replaces semadb_tpu/ops/pallas/hamming.py · pairwise_bit_distance_pallas
// (_hamming_kernel, _jaccard_kernel: the blocked Pallas scan of the
// binary-quantized flat index).
//
//   hamming(q, x) = sum_w popcount(q[w] ^ x[w])
//   jaccard(q, x) = 1 - sum_w popcount(q[w] & x[w]) / sum_w popcount(q[w] | x[w]),
//                   and 0 where the union is 0
//
// queries i32[B, W] x codes i32[N, W] -> f32[B, N]. The codes are the JAX
// package's u32 words, stored as int32 (the same bits).
//
// Two routes, one function; the caller picks one by B (and W).
//
// The tensor-core route (bit_distance_kernel_mma). With inter = |q AND x|,
//   hamming = |q| + |x| - 2 inter,  jaccard = 1 - inter / (|q| + |x| - inter),
// and inter is what the single-bit MMA counts: mma.sync m16n8k256 b1 with
// AND + popc takes 256 bits of 16 code rows and 8 queries a step, straight
// from the packed words (a code row is a row of A, a query a column of B, 8
// words a k-step; nothing is transposed). The AND-popc counts that kept the
// integer pipe busy for ~1.5 ms at B = 4096 over N = 32768, W = 48 now take
// the tensor cores ~0.04 ms, so what bounds the work is bytes: the f32[B, N]
// output, 537 MB there, about 0.16 ms at 3.35 TB/s. The design:
//   - one wave of blocks, each walking an even share of the (query tile,
//     code tile) pairs: it keeps its query tile resident in shared memory
//     and double-buffers the code tiles with cp.async (16-byte copies when
//     W % 4 == 0 and both row bases are 16-byte aligned, 4-byte copies
//     otherwise), so the next tile's loads overlap this tile's MMAs;
//   - a tile is 64 code rows x 128 queries above 64 queries (each code row
//     read from L2 once per 128 queries), 128 x 64 up to 64 queries (twice
//     the blocks for a small batch); 8 warps of 32 x 32 each: per k-step two
//     ldmatrix.x4 for A, two for B, eight MMAs;
//   - rows are W8 + 4 words apart in shared memory (W8 = W rounded up to 8),
//     so ldmatrix's 8 rows fall in 8 distinct bank quads; the words from W
//     to W8 are zero, so a ragged last k-step adds nothing to inter, |q| or
//     |x|;
//   - |x| comes from the A fragments each thread already holds (popc of its
//     words, summed over the 4 lanes of a row), |q| once per query tile:
//     N*W + B*W popcounts against B*N*W, no new state;
//   - the accumulators (two neighbouring queries of one code row a thread)
//     go through a shared-memory tile, so out[b, n] is written as 16-byte
//     streaming stores along n (4-byte ones when N % 4 != 0); the ragged
//     edges in B and N are masked at the store;
//   - warps whose queries all lie past B skip their MMAs.
// What it does not yet do: overlap a tile's stores with the next tile's
// shared-memory traffic (both operands through ldmatrix, the accumulators
// through the staging tile) inside a block; two blocks an SM overlap them
// only in part (PERF.md, section 6, has the times against the bound).
//
// The CUDA-core route (bit_distance_kernel), the first version: a block
// stages TQ queries in shared memory (TQ the smallest of 1, 8, 32 that
// covers B), each thread owns one code row, read once as 16-byte loads, and
// keeps TQ popcount sums in registers. It is bound by bytes at one query and
// by popcount throughput (16 a clock per SM) from a few queries up. At B = 1 it
// wastes nothing on idle MMA columns and is the faster route, so it stays.
//
// B above 65535 is split into launches by the caller. Built with nvcc for
// sm_90a into a shared library with a plain C interface
// (semadb_tpu_torch/ops/kernels/hamming.py). No --use_fast_math: jaccard's
// division is IEEE f32 division (__fdiv_rn) of exact integer counts, as in
// the JAX version, so both routes agree with it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// -- CUDA-core route ------------------------------------------------------------

constexpr int kThreads = 128;          // code rows per block
constexpr int kSmemWords = 12 * 1024;  // 48 KB of query words at most

template <int TQ, bool JACCARD, bool VEC4>
__global__ void __launch_bounds__(kThreads)
bit_distance_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                    float* __restrict__ out, int B, int N, int W) {
  extern __shared__ uint32_t sq[];  // TQ * W words
  const int b0 = blockIdx.y * TQ;
  const int nq = min(TQ, B - b0);
  // Stage the query tile; rows past B are zero and never written out.
  for (int i = threadIdx.x; i < TQ * W; i += kThreads) {
    sq[i] = (i < nq * W) ? q[(size_t)b0 * W + i] : 0u;
  }
  __syncthreads();

  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const uint32_t* row = x + (size_t)n * W;

  int acc[TQ];
  int uni[JACCARD ? TQ : 1];
#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    acc[j] = 0;
    if (JACCARD) uni[j] = 0;
  }

  auto accumulate = [&](uint32_t xw, int w) {
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const uint32_t qw = sq[j * W + w];
      if (JACCARD) {
        acc[j] += __popc(qw & xw);
        uni[j] += __popc(qw | xw);
      } else {
        acc[j] += __popc(qw ^ xw);
      }
    }
  };

  if (VEC4) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int w4 = 0; w4 < W / 4; ++w4) {
      const uint4 v = __ldg(row4 + w4);
      accumulate(v.x, 4 * w4);
      accumulate(v.y, 4 * w4 + 1);
      accumulate(v.z, 4 * w4 + 2);
      accumulate(v.w, 4 * w4 + 3);
    }
  } else {
    for (int w = 0; w < W; ++w) accumulate(__ldg(row + w), w);
  }

#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    if (j < nq) {
      float d;
      if (JACCARD) {
        d = uni[j] == 0 ? 0.0f
                        : 1.0f - __fdiv_rn((float)acc[j], (float)max(uni[j], 1));
      } else {
        d = (float)acc[j];
      }
      out[(size_t)(b0 + j) * N + n] = d;
    }
  }
}

template <int TQ, bool JACCARD>
cudaError_t launch_tq(const uint32_t* q, const uint32_t* x, float* out, int B,
                      int N, int W, bool vec4, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads),
                  (unsigned)((B + TQ - 1) / TQ));
  const size_t smem = (size_t)TQ * W * sizeof(uint32_t);
  if (vec4) {
    bit_distance_kernel<TQ, JACCARD, true><<<grid, kThreads, smem, stream>>>(q, x, out, B, N, W);
  } else {
    bit_distance_kernel<TQ, JACCARD, false><<<grid, kThreads, smem, stream>>>(q, x, out, B, N, W);
  }
  return cudaGetLastError();
}

template <bool JACCARD>
cudaError_t launch_cuda_core(const uint32_t* q, const uint32_t* x, float* out, int B,
                             int N, int W, bool vec4, cudaStream_t stream) {
  if (W > kSmemWords) return cudaErrorInvalidValue;
  if (B <= 1 || 8 * W > kSmemWords) {
    return launch_tq<1, JACCARD>(q, x, out, B, N, W, vec4, stream);
  }
  if (B <= 8 || 32 * W > kSmemWords) {
    return launch_tq<8, JACCARD>(q, x, out, B, N, W, vec4, stream);
  }
  return launch_tq<32, JACCARD>(q, x, out, B, N, W, vec4, stream);
}

// -- tensor-core route ----------------------------------------------------------

// Every warp computes a tile of 32 code rows x 32 queries; a block of BM code
// rows x BN queries has BM / 32 warps along the codes and BN / 32 along the
// queries.
constexpr int kWarpRows = 32;
constexpr int kWarpCols = 32;
constexpr int kMT = kWarpRows / 16;  // m16 tiles a warp
constexpr int kNT = kWarpCols / 8;   // n8 tiles a warp

template <int BM, int BN>
struct MmaTile {
  static constexpr int kWarpsM = BM / kWarpRows;
  static constexpr int kThreads = 32 * kWarpsM * (BN / kWarpCols);
  static constexpr int kStageStride = BM + 4;  // floats a row of the output tile
  static size_t smem_bytes(int W) {
    const int stride = ((W + 7) & ~7) + 4;
    return sizeof(uint32_t) *
           ((size_t)(BN + 2 * BM) * stride + (size_t)BN * kStageStride + BN);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8 x 4-word matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16 x 8] += popc(A[16 x 256] AND B[256 x 8]), one bit an element.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of W words (global, W apart) into shared rows `stride`
// words apart; rows past `rows` are left as they are.
template <int THREADS, bool VEC4>
__device__ __forceinline__ void load_rows(uint32_t* dst, const uint32_t* src, int rows, int W,
                                          int stride) {
  if (VEC4) {
    const int per_row = W / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int r = i / per_row, c = 4 * (i - r * per_row);
      cp_async16(dst + r * stride + c, src + (size_t)r * W + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += THREADS) {
      const int r = i / W, c = i - r * W;
      cp_async4(dst + r * stride + c, src + (size_t)r * W + c);
    }
  }
}

// A work item is one (query tile, code tile) pair, numbered query tile
// first. The grid is one wave of blocks; block b takes the items
// [b * T / G, (b + 1) * T / G) of T, so the blocks' shares differ by one
// item at most and a block's query tile changes only where its run of items
// crosses into the next query tile.
template <int BM, int BN, bool JACCARD, bool VEC4>
__global__ void __launch_bounds__(MmaTile<BM, BN>::kThreads, 512 / MmaTile<BM, BN>::kThreads)
bit_distance_kernel_mma(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                        float* __restrict__ out, int B, int N, int W, bool vec4_out) {
  using T = MmaTile<BM, BN>;
  constexpr int kThreads = T::kThreads;
  constexpr int kStageStride = T::kStageStride;
  extern __shared__ __align__(16) uint32_t smem[];
  const int W8 = (W + 7) & ~7;
  const int stride = W8 + 4;
  uint32_t* sq = smem;                                                // BN rows
  uint32_t* sx = sq + BN * stride;                                    // 2 x BM rows
  float* stage = reinterpret_cast<float*>(sx + 2 * BM * stride);      // BN x kStageStride
  int* q_count = reinterpret_cast<int*>(stage + BN * kStageStride);  // |q| of the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;            // MMA fragment row group, thread in group
  const int wm0 = (warp % T::kWarpsM) * kWarpRows;  // the warp's code rows in a tile
  const int wn0 = (warp / T::kWarpsM) * kWarpCols;  // the warp's queries in the tile
  const int ntiles = (N + BM - 1) / BM;
  const long long items = (long long)((B + BN - 1) / BN) * ntiles;
  long long item = items * blockIdx.x / gridDim.x;
  const long long end = items * (blockIdx.x + 1) / gridDim.x;
  if (item >= end) return;
  auto code_tile = [&](long long i) { return (int)(i % ntiles); };
  auto load_codes = [&](uint32_t* dst, int tile) {
    load_rows<kThreads, VEC4>(dst, x + (size_t)tile * BM * W, min(BM, N - tile * BM), W, stride);
  };

  // Zero the words W..W8 of every row once; the copies never write them.
  const int pad = W8 - W;
  for (int i = tid; i < (BN + 2 * BM) * pad; i += kThreads) {
    smem[(i / pad) * stride + W + i % pad] = 0u;
  }
  int qt = (int)(item / ntiles);
  int b0 = qt * BN, nq = min(BN, B - b0);
  load_rows<kThreads, VEC4>(sq, q + (size_t)b0 * W, nq, W, stride);
  load_codes(sx, code_tile(item));
  cp_async_commit();
  bool fresh = true;  // the query tile in sq has no counts yet
  int q_cnt[kNT][2];  // |q| of the thread's queries wn0 + 8j + 2t + h

  // ldmatrix row addresses: A = 16 code rows x 8 words, as matrices
  // (rows 0-7, words 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) = a0..a3;
  // B = 16 queries x 8 words, as (0-7, 0-3), (0-7, 4-7), (8-15, 0-3),
  // (8-15, 4-7) = b0, b1 of the first n8 tile, then of the second.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 4;

  for (int it = 0; item < end; ++it, ++item) {
    const uint32_t* cur = sx + (it & 1) * BM * stride;
    uint32_t* other = sx + ((it + 1) & 1) * BM * stride;
    const long long next = item + 1;
    const bool prefetch = next < end && next / ntiles == qt;
    if (prefetch) {
      load_codes(other, code_tile(next));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (fresh) {
      constexpr int kPerRow = kThreads / BN;  // threads that count one query row
      int c = 0;
      for (int w = tid % kPerRow; w < W8; w += kPerRow) c += __popc(sq[(tid / kPerRow) * stride + w]);
#pragma unroll
      for (int o = 1; o < kPerRow; o *= 2) c += __shfl_xor_sync(0xffffffffu, c, o);
      if (tid % kPerRow == 0) q_count[tid / kPerRow] = c;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        q_cnt[j][0] = q_count[wn0 + j * 8 + 2 * t];
        q_cnt[j][1] = q_count[wn0 + j * 8 + 2 * t + 1];
      }
      fresh = false;
    }

    if (wn0 < nq) {  // else every query of the warp lies past B
      int acc[kMT][kNT][4];
      int x_count[kMT][2];  // |x| of code rows g and g + 8 of each m16 tile
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        x_count[i][0] = x_count[i][1] = 0;
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
      }
      const int live_pairs = min(kNT / 2, (nq - wn0 + 15) / 16);  // n8 pairs with a query < B
      for (int k0 = 0; k0 < W8; k0 += 8) {
        uint32_t a[kMT][4], b[kNT / 2][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          ldmatrix_x4(a[i], cur + (wm0 + i * 16 + a_row) * stride + k0 + a_col);
        }
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          if (jj < live_pairs) ldmatrix_x4(b[jj], sq + (wn0 + jj * 16 + b_row) * stride + k0 + b_col);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          x_count[i][0] += __popc(a[i][0]) + __popc(a[i][2]);
          x_count[i][1] += __popc(a[i][1]) + __popc(a[i][3]);
        }
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          if (jj < live_pairs) {
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
              mma_and_popc(acc[i][2 * jj], a[i], b[jj][0], b[jj][1]);
              mma_and_popc(acc[i][2 * jj + 1], a[i], b[jj][2], b[jj][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x_count[i][h] += __shfl_xor_sync(0xffffffffu, x_count[i][h], 1);
          x_count[i][h] += __shfl_xor_sync(0xffffffffu, x_count[i][h], 2);
        }
      }
      // Accumulator r of tile (i, j): code row wm0 + 16i + g + 8(r / 2),
      // query wn0 + 8j + 2t + r % 2.
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int inter = acc[i][j][r];
            const int sum = q_cnt[j][r & 1] + x_count[i][r >> 1];
            float d;
            if (JACCARD) {
              const int uni = sum - inter;
              d = uni == 0 ? 0.0f : 1.0f - __fdiv_rn((float)inter, (float)max(uni, 1));
            } else {
              d = (float)(sum - 2 * inter);
            }
            stage[(wn0 + j * 8 + 2 * t + (r & 1)) * kStageStride + wm0 + i * 16 + g + (r >> 1) * 8] = d;
          }
        }
      }
    }
    __syncthreads();

    const int n0 = code_tile(item) * BM;
    const int ncols = min(BM, N - n0);
    if (vec4_out) {
      for (int i = tid; i < nq * (BM / 4); i += kThreads) {
        const int row = i / (BM / 4), c = 4 * (i % (BM / 4));
        if (c < ncols) {
          __stcs(reinterpret_cast<float4*>(out + (size_t)(b0 + row) * N + n0 + c),
                 *reinterpret_cast<const float4*>(stage + row * kStageStride + c));
        }
      }
    } else {
      for (int i = tid; i < nq * BM; i += kThreads) {
        const int row = i / BM, c = i % BM;
        if (c < ncols) __stcs(out + (size_t)(b0 + row) * N + n0 + c, stage[row * kStageStride + c]);
      }
    }
    if (next < end && !prefetch) {  // the next item starts a new query tile
      qt = (int)(next / ntiles);
      b0 = qt * BN;
      nq = min(BN, B - b0);
      load_rows<kThreads, VEC4>(sq, q + (size_t)b0 * W, nq, W, stride);
      load_codes(other, code_tile(next));
      cp_async_commit();
      fresh = true;
    }
  }
}

// Launches one wave: as many blocks as fit on the card at once, or fewer
// where there are fewer items. The kernel opts in to all the shared memory
// a block may have: one value whatever W, so concurrent callers at other
// widths cannot take it away between this call's opt-in and its launch.
template <int BM, int BN, bool JACCARD, bool VEC4>
cudaError_t launch_tile(const uint32_t* q, const uint32_t* x, float* out, int B, int N, int W,
                        bool vec4_out, cudaStream_t stream) {
  using T = MmaTile<BM, BN>;
  auto kernel = bit_distance_kernel_mma<BM, BN, JACCARD, VEC4>;
  const size_t smem = T::smem_bytes(W);
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((B + BN - 1) / BN) * ((N + BM - 1) / BM);
  const long long blocks = std::min(items, (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)blocks, T::kThreads, smem, stream>>>(q, x, out, B, N, W, vec4_out);
  return cudaGetLastError();
}

// Up to kSmallB queries the blocks take 128 code rows x 64 queries, so that
// a small batch still spreads over the whole card; above it 64 code rows x
// 128 queries, which halves how often each code row is read from L2.
constexpr int kSmallB = 64;

template <bool JACCARD, bool VEC4>
cudaError_t launch_mma_vec(const uint32_t* q, const uint32_t* x, float* out, int B, int N, int W,
                           bool vec4_out, cudaStream_t stream) {
  return B <= kSmallB ? launch_tile<128, 64, JACCARD, VEC4>(q, x, out, B, N, W, vec4_out, stream)
                      : launch_tile<64, 128, JACCARD, VEC4>(q, x, out, B, N, W, vec4_out, stream);
}

template <bool JACCARD>
cudaError_t launch_mma(const uint32_t* q, const uint32_t* x, float* out, int B, int N, int W,
                       bool vec4, bool vec4_out, cudaStream_t stream) {
  return vec4 ? launch_mma_vec<JACCARD, true>(q, x, out, B, N, W, vec4_out, stream)
              : launch_mma_vec<JACCARD, false>(q, x, out, B, N, W, vec4_out, stream);
}

}  // namespace

extern "C" {

// metric: 0 = hamming, 1 = jaccard. route: 0 = CUDA cores, 1 = tensor cores.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for operands the route does not take. Launches on
// `stream`; does not synchronise.
int semadb_bit_distance(const void* queries, const void* codes, void* out, int B, int N,
                        int W, int metric, int route, void* stream) {
  if (B <= 0 || N <= 0 || W <= 0 || B > 65535 || (metric != 0 && metric != 1) ||
      (route != 0 && route != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  const uint32_t* x = static_cast<const uint32_t*>(codes);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (route == 0) {
    const bool vec4 = (W % 4 == 0) && x16;
    return (int)(metric == 1 ? launch_cuda_core<true>(q, x, o, B, N, W, vec4, s)
                             : launch_cuda_core<false>(q, x, o, B, N, W, vec4, s));
  }
  const bool vec4 = (W % 4 == 0) && x16 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool vec4_out = (N % 4 == 0) && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  return (int)(metric == 1 ? launch_mma<true>(q, x, o, B, N, W, vec4, vec4_out, s)
                           : launch_mma<false>(q, x, o, B, N, W, vec4, vec4_out, s));
}

const char* semadb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
