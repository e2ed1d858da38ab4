// Shared by K10 (vamana_search.cu) and K11 (vamana_prune.cu): the metrics'
// codes and the haversine distance of the JAX package's _haversine_pair
// (semadb_tpu/ops/distance.py), in meters for [lat, lon] degrees.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vamana {

constexpr int kNil = -1;
constexpr float kDegToRad = (float)(3.14159265358979323846 / 180.0);
constexpr float kEarthRadius = 6371000.0f;

enum Metric { kEuclidean = 0, kDot = 1, kCosine = 2, kHaversine = 3 };

// x is the first argument of _haversine_pair. Every product and sum is
// rounded once, in PyTorch's order (no contraction into FMAs), so that the
// kernels' meters are the plain versions' bit for bit on the card.
__device__ __forceinline__ float haversine(float x0, float x1, float y0, float y1) {
  const float latx = __fmul_rn(x0, kDegToRad), lonx = __fmul_rn(x1, kDegToRad);
  const float laty = __fmul_rn(y0, kDegToRad), lony = __fmul_rn(y1, kDegToRad);
  const float sdlat = sinf(__fdiv_rn(__fsub_rn(latx, laty), 2.0f));
  const float sdlon = sinf(__fdiv_rn(__fsub_rn(lonx, lony), 2.0f));
  const float a = __fadd_rn(__fmul_rn(sdlat, sdlat),
                            __fmul_rn(__fmul_rn(__fmul_rn(cosf(latx), cosf(laty)), sdlon), sdlon));
  const float c = __fmul_rn(2.0f, asinf(sqrtf(fminf(fmaxf(a, 0.0f), 1.0f))));
  return __fmul_rn(kEarthRadius, c);
}

}  // namespace vamana
