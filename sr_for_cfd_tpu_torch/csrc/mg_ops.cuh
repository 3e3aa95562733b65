// The level arithmetic of the V-cycle, shared by the stage kernels and the
// one-block coarse tail (mg_vcycle.cu) and the streamed V-cycle passes
// (stream_mg.cu's staged form, stream_pass.cu's fused one). Every caller
// computes a cell with these expressions in this order, so that (under
// -fmad=false) they give the same bits whether a level lives in global
// memory, shared memory or registers.
#pragma once

#include <cuda_runtime.h>

// row transfer modes (ops/mg_kernels.py ROW_*)
#define MG_ROW_BAND 0
#define MG_ROW_RESTRICT_2X 1
#define MG_ROW_PROLONG_2X 2
#define MG_ROW_COPY 3

// volp-scaled 5-point Laplacian from the cell c and its neighbours at
// i + 1 (e), i - 1 (w), j + 1 (no) and j - 1 (so)
__device__ __forceinline__ float mg_lap5(float c, float e, float w, float no,
                                         float so, float inv_dx2, float inv_dy2,
                                         float volp) {
  return volp * ((e - 2.0f * c + w) * inv_dx2 + (no - 2.0f * c + so) * inv_dy2);
}

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
  return mg_lap5(c, e, w, no, so, inv_dx2, inv_dy2, volp);
}

// r = b - A x at (i, j)
__device__ __forceinline__ float mg_residual_at(const float* x, const float* b,
                                                int i, int j, int n, int m,
                                                float inv_dx2, float inv_dy2,
                                                float volp) {
  return b[i * m + j] - mg_lap(x, i, j, n, m, inv_dx2, inv_dy2, volp);
}

// the smoother's new value at (i, j): x + (b - A x) * inv_ap (omega folded
// into inv_ap)
__device__ __forceinline__ float mg_smoothed_at(const float* x, const float* b,
                                                int i, int j, int n, int m,
                                                float inv_dx2, float inv_dy2,
                                                float volp, float inv_ap) {
  const float r = mg_residual_at(x, b, i, j, n, m, inv_dx2, inv_dy2, volp);
  return x[i * m + j] + r * inv_ap;
}

// Row transfer of output row I, column j, before the scale:
// MG_ROW_BAND: sum_{i in [lo[I], hi[I])} mat[I, i] in[i, j] (true f32 FMAs)
// MG_ROW_RESTRICT_2X: in[2I-1] + 3 in[2I] + 3 in[2I+1] + in[2I+2] (zero
//   outside), times 1/7 on the two boundary rows, 1/8 elsewhere
// MG_ROW_PROLONG_2X: out[2k] = 0.75 in[k] + 0.25 in[k-1],
//   out[2k+1] = 0.75 in[k] + 0.25 in[k+1] (edge-replicated)
// MG_ROW_COPY: in[I, j]
__device__ __forceinline__ float mg_row_value(const float* in, int I, int j,
                                              int n_in, int n_out, int m,
                                              int mode, const float* mat,
                                              const int* lo, const int* hi) {
  if (mode == MG_ROW_RESTRICT_2X) {
    const float a = I > 0 ? in[(2 * I - 1) * m + j] : 0.0f;
    const float bb = in[(2 * I) * m + j];
    const float cc = in[(2 * I + 1) * m + j];
    const float d = 2 * I + 2 < n_in ? in[(2 * I + 2) * m + j] : 0.0f;
    float u = a + 3.0f * bb;
    u = u + 3.0f * cc;
    u = u + d;
    return u * ((I == 0 || I == n_out - 1) ? (1.0f / 7.0f) : 0.125f);
  }
  if (mode == MG_ROW_PROLONG_2X) {
    const int k = I >> 1;
    const int nb = (I & 1) ? min(k + 1, n_in - 1) : max(k - 1, 0);
    return 0.75f * in[k * m + j] + 0.25f * in[nb * m + j];
  }
  if (mode == MG_ROW_COPY) return in[I * m + j];
  float acc = 0.0f;
  const int end = hi[I];
  for (int i = lo[I]; i < end; ++i)
    acc = fmaf(mat[(size_t)I * n_in + i], in[(size_t)i * m + j], acc);
  return acc;
}

// Column transfer of row i, output column J, before the scale:
// sum_{j in [lo[J], hi[J])} in[i, j] mat_t[j, J] (true f32 FMAs)
__device__ __forceinline__ float mg_col_value(const float* in, int i, int J,
                                              int m_in, int m_out,
                                              const float* mat_t, const int* lo,
                                              const int* hi) {
  float acc = 0.0f;
  const int end = hi[J];
  for (int j = lo[J]; j < end; ++j)
    acc = fmaf(in[(size_t)i * m_in + j], mat_t[(size_t)j * m_out + J], acc);
  return acc;
}

// out[o] = v * scale, or out[o] += v * scale with accumulate
__device__ __forceinline__ void mg_transfer_store(float* out, int o, float v,
                                                  float scale, int accumulate) {
  v = v * scale;
  out[o] = accumulate ? out[o] + v : v;
}
