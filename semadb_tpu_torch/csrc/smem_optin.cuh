// The dynamic shared-memory opt-in of the kernels that take more than 48 KB
// a block: K3 (ivf_scan.cu), K4 (ivf_rerank.cu), K5 (ivf_probe_topk.cu), K9
// (ivf_pq_scan.cu), K10 (vamana_search.cu) and K11 (vamana_prune.cu).
//
// A kernel is opted in once per device, to the most a block may have there
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, less the kernel's static shared
// memory), never to one call's own size.
// The value is the same for every caller, so a host thread that launches
// the kernel at a small size cannot lower the opt-in between another
// thread's opt-in and its launch at a larger size (a node's HTTP, RPC and
// fan-out threads all launch). The opt-in does not change what a launch
// takes: that is the size given at the launch, which occupancy queries keep
// using too.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>
#include <vector>

// The kernel's room for dynamic shared memory on the current device: the
// most a block may opt in to less the kernel's own static shared memory.
// Opts the kernel in to that room the first time it is asked for a device,
// and refuses `bytes` above it (cudaErrorInvalidValue). (A function at
// global scope: the kernels name their shared arrays smem.)
inline cudaError_t smem_opt_in(const void* kernel, size_t bytes) {
  struct OptIn {
    const void* kernel;
    int device;
    size_t room;
  };
  static std::mutex mu;
  static std::vector<OptIn> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(mu);
  for (const OptIn& d : done) {
    if (d.kernel == kernel && d.device == dev) return bytes > d.room ? cudaErrorInvalidValue : cudaSuccess;
  }
  int most = 0;
  cudaFuncAttributes attr;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const int room = most - (int)attr.sharedSizeBytes;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
  if (e != cudaSuccess) return e;
  done.push_back({kernel, dev, (size_t)room});
  return bytes > (size_t)room ? cudaErrorInvalidValue : cudaSuccess;
}
