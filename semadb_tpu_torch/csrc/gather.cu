// Row gather out = vectors[ids], for Hopper.
//
// Replaces semadb_tpu/ops/pallas/gather.py · gather_rows / gather_rows_padded
// (_gather_kernel): per-row DMAs from HBM, 16 in flight, 1,024 ids per grid
// program, ids padded by the caller to whole programs.
//
//   vectors [cap, row_bytes] x ids i32[n] -> out [n, row_bytes]
//
// The copy is by bytes, so the kernel does not care about the element type;
// the wrapper (semadb_tpu_torch/ops/kernels/gather.py) admits float32.
//
// What bounds it on the H100: bytes. It does no arithmetic; it reads each id
// once, each row it names (rows named twice may come from L2), and writes
// each output row once. At 512-byte rows the reads are random 512-byte
// segments, so the question is whether enough of them are in flight.
//
// What the design does about it:
//   - one warp per output row, a grid-stride loop over rows; the warp's 32
//     lanes read the row's id at one address (one transaction), then copy the
//     row as 16-byte loads and stores when the row length and both base
//     pointers allow it, else as 4-byte ones: a 512-byte row is one load and
//     one store instruction per lane group, fully coalesced;
//   - the grid is sized to fill every SM with 2,048 threads (64 warps, so
//     64 rows in flight per SM, 8,448 on the card); the TPU kernel's DMA
//     queue depth has no counterpart: resident warps hide the latency;
//   - the ragged edge in n needs no padding: the loop stops at n;
//   - an id outside [0, cap) is never read: its output row is zeroed and,
//     when the caller passes a flag, the flag counts it (the wrapper's
//     check=True path reads it and raises). Nothing is clamped.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kBlocksPerSm = 2048 / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ src, const int32_t* __restrict__ ids,
                   T* __restrict__ out, long long n, long long cap, int row_units,
                   int* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); r < n;
       r += nwarps) {
    const long long id = __ldg(ids + r);
    T* dst = out + r * row_units;
    if (id < 0 || id >= cap) {
      if (lane == 0 && bad != nullptr) atomicAdd(bad, 1);
      for (int u = lane; u < row_units; u += 32) dst[u] = T{};
      continue;
    }
    const T* row = src + id * row_units;
    for (int u = lane; u < row_units; u += 32) dst[u] = __ldg(row + u);
  }
}

template <typename T>
cudaError_t launch(const void* vectors, const int32_t* ids, void* out, long long n,
                   long long cap, long long row_bytes, int* bad, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long want = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long full = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(want < full ? want : full);
  gather_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vectors), ids, static_cast<T*>(out), n, cap,
      (int)(row_bytes / sizeof(T)), bad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// vectors: cap rows of row_bytes bytes; ids: n int32; out: n rows of
// row_bytes. bad: an int on the device that counts ids outside [0, cap), or
// null. Returns cudaGetLastError() after the launch (0 on success). Launches
// on `stream`; does not synchronise.
int semadb_gather_rows(const void* vectors, const void* ids, void* out, long long n,
                       long long cap, long long row_bytes, void* bad, void* stream) {
  if (n <= 0 || cap < 0 || row_bytes <= 0 || row_bytes % 4 != 0 ||
      row_bytes / 4 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int32_t* i = static_cast<const int32_t*>(ids);
  int* b = static_cast<int*>(bad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return (int)(vec16 ? launch<uint4>(vectors, i, out, n, cap, row_bytes, b, s)
                     : launch<uint32_t>(vectors, i, out, n, cap, row_bytes, b, s));
}

const char* semadb_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
