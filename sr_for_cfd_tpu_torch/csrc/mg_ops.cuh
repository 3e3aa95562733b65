// The level Laplacian shared by the V-cycle stages (mg_vcycle.cu) and the
// streamed V-cycle passes (stream_mg.cu).
#pragma once

#include <cuda_runtime.h>

// volp-scaled 5-point Laplacian of an interior-shaped (n, m) level with a
// homogeneous-Dirichlet exterior, at (i, j); m is the contiguous axis
__device__ __forceinline__ float mg_lap(const float* __restrict__ x, int i,
                                        int j, int n, int m, float inv_dx2,
                                        float inv_dy2, float volp) {
  const int idx = i * m + j;
  const float c = x[idx];
  const float e = i + 1 < n ? x[idx + m] : 0.0f;
  const float w = i > 0 ? x[idx - m] : 0.0f;
  const float no = j + 1 < m ? x[idx + 1] : 0.0f;
  const float so = j > 0 ? x[idx - 1] : 0.0f;
  return volp * ((e - 2.0f * c + w) * inv_dx2 + (no - 2.0f * c + so) * inv_dy2);
}
