// Geometric-multigrid V-cycle pressure loop, one kernel per V-cycle stage.
//
// Replaces the TPU kernel sr_for_cfd_tpu/ops/pallas_mg.py:415
// (pallas_mg_solve_pressure; body _mg_kernel at :391, loop mg_while_loop
// :348, level operators make_level_ops :232), which keeps the whole level
// hierarchy in VMEM and runs every cycle inside one launch.
//
// Bound. Every stage streams its level once: a smoother half-sweep reads x
// and b and writes x (~8 bytes per cell), the residual reads x and b and
// writes r, a transfer reads its input and writes its output. At 400x400
// (160,000 cells, 0.64 MB per array) one V-cycle (4+4 sweeps per level)
// moves roughly 40 MB over all levels -- ~12 us at 3.35 TB/s of device
// memory, and less, since the whole hierarchy (~3 MB) stays in the 50 MB
// L2. One V-cycle is ~200 launches, so at several us per launch the loop
// is bound by launch latency, then by L2 bandwidth, not by arithmetic.
//
// Design. The host walks the levels recursively, as make_level_ops.v_cycle
// does, and launches:
//   * mg_smooth_half: one red-black half-sweep at a level (interior-shaped
//     arrays, zero exterior, in place: a cell reads only the other colour);
//   * mg_residual: r = b - A x, optionally with per-block sums of r^2;
//   * mg_row_transfer / mg_col_transfer: restriction and prolongation. Rows
//     use the exact-2x [1,3,3,1] restriction or [0.75,0.25] prolongation
//     where the level halves exactly, else a banded matrix; columns use a
//     banded matrix. Each output sums only its band (bounds passed in), in
//     true f32 FMAs -- no tensor cores, so no TF32 -- and the last transfer
//     of a restriction applies the level scale, the last of a prolongation
//     adds into x;
//   * srcfd_rms_finalize (rb_sor.cu): the fine-level rms from the partials
//     in a fixed order, read by the host once per cycle.
// No kernel waits on another block; every loop is bounded by sizes or by
// max_cycles, which the wrapper passes in.

#include "common.cuh"
#include "mg_ops.cuh"

__global__ void __launch_bounds__(SRCFD_THREADS)
mg_smooth_half_kernel(float* __restrict__ x, const float* __restrict__ b, int n,
                      int m, float inv_dx2, float inv_dy2, float volp,
                      float inv_ap, int color) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m || ((i + j) & 1) != color) return;
  const int idx = i * m + j;
  const float r = b[idx] - mg_lap(x, i, j, n, m, inv_dx2, inv_dy2, volp);
  x[idx] = x[idx] + r * inv_ap;
}

__global__ void __launch_bounds__(SRCFD_THREADS)
mg_residual_kernel(const float* __restrict__ x, const float* __restrict__ b,
                   float* __restrict__ r_out, float* __restrict__ partials,
                   int n, int m, float inv_dx2, float inv_dy2, float volp) {
  __shared__ float sh[SRCFD_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float r2 = 0.0f;
  if (i < n && j < m) {
    const int idx = i * m + j;
    const float r = b[idx] - mg_lap(x, i, j, n, m, inv_dx2, inv_dy2, volp);
    if (r_out != nullptr) r_out[idx] = r;
    r2 = r * r;
  }
  if (partials != nullptr) {  // uniform over the block
    const float s = srcfd_block_sum(r2, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// mode 0: out[I, j] = sum_{i in [lo[I], hi[I])} mat[I, i] in[i, j]
// mode 1: exact-2x restriction, in[2I-1] + 3 in[2I] + 3 in[2I+1] + in[2I+2]
//         (zero outside), times 1/7 on the two boundary rows, 1/8 elsewhere
// mode 2: exact-2x prolongation, out[2k] = 0.75 in[k] + 0.25 in[k-1],
//         out[2k+1] = 0.75 in[k] + 0.25 in[k+1] (edge-replicated)
// mode 3: rows kept, out[I, j] = in[I, j]
// then out = v * scale, or out += v * scale with accumulate
__global__ void __launch_bounds__(SRCFD_THREADS)
mg_row_transfer_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int n_in, int n_out, int m, int mode,
                       const float* __restrict__ mat, const int* __restrict__ lo,
                       const int* __restrict__ hi, float scale, int accumulate) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int I = blockIdx.y * blockDim.y + threadIdx.y;
  if (I >= n_out || j >= m) return;
  float v;
  if (mode == 1) {
    const float a = I > 0 ? in[(2 * I - 1) * m + j] : 0.0f;
    const float bb = in[(2 * I) * m + j];
    const float cc = in[(2 * I + 1) * m + j];
    const float d = 2 * I + 2 < n_in ? in[(2 * I + 2) * m + j] : 0.0f;
    float u = a + 3.0f * bb;
    u = u + 3.0f * cc;
    u = u + d;
    v = u * ((I == 0 || I == n_out - 1) ? (1.0f / 7.0f) : 0.125f);
  } else if (mode == 2) {
    const int k = I >> 1;
    const int nb = (I & 1) ? min(k + 1, n_in - 1) : max(k - 1, 0);
    v = 0.75f * in[k * m + j] + 0.25f * in[nb * m + j];
  } else if (mode == 3) {
    v = in[I * m + j];
  } else {
    float acc = 0.0f;
    const int end = hi[I];
    for (int i = lo[I]; i < end; ++i)
      acc = fmaf(mat[(size_t)I * n_in + i], in[(size_t)i * m + j], acc);
    v = acc;
  }
  v = v * scale;
  const int o = I * m + j;
  out[o] = accumulate ? out[o] + v : v;
}

// out[i, J] = sum_{j in [lo[J], hi[J])} in[i, j] mat_t[j, J]
__global__ void __launch_bounds__(SRCFD_THREADS)
mg_col_transfer_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int n, int m_in, int m_out,
                       const float* __restrict__ mat_t, const int* __restrict__ lo,
                       const int* __restrict__ hi, float scale, int accumulate) {
  const int J = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || J >= m_out) return;
  float acc = 0.0f;
  const int end = hi[J];
  for (int j = lo[J]; j < end; ++j)
    acc = fmaf(in[(size_t)i * m_in + j], mat_t[(size_t)j * m_out + J], acc);
  const float v = acc * scale;
  const int o = i * m_out + J;
  out[o] = accumulate ? out[o] + v : v;
}

extern "C" {

// number of partial sums mg_residual writes for an (n, m) level
int srcfd_mg_partials(int n, int m) {
  const dim3 g = srcfd_grid(n, m);
  return (int)(g.x * g.y);
}

int srcfd_mg_smooth_half(float* x, const float* b, int n, int m, float inv_dx2,
                         float inv_dy2, float volp, float inv_ap, int color,
                         void* stream) {
  mg_smooth_half_kernel<<<srcfd_grid(n, m), dim3(SRCFD_TX, SRCFD_TY), 0,
                          (cudaStream_t)stream>>>(x, b, n, m, inv_dx2, inv_dy2,
                                                  volp, inv_ap, color);
  return (int)cudaGetLastError();
}

int srcfd_mg_residual(const float* x, const float* b, float* r_out,
                      float* partials, int n, int m, float inv_dx2,
                      float inv_dy2, float volp, void* stream) {
  mg_residual_kernel<<<srcfd_grid(n, m), dim3(SRCFD_TX, SRCFD_TY), 0,
                       (cudaStream_t)stream>>>(x, b, r_out, partials, n, m,
                                               inv_dx2, inv_dy2, volp);
  return (int)cudaGetLastError();
}

int srcfd_mg_row_transfer(const float* in, float* out, int n_in, int n_out,
                          int m, int mode, const float* mat, const int* lo,
                          const int* hi, float scale, int accumulate,
                          void* stream) {
  mg_row_transfer_kernel<<<srcfd_grid(n_out, m), dim3(SRCFD_TX, SRCFD_TY), 0,
                           (cudaStream_t)stream>>>(in, out, n_in, n_out, m,
                                                   mode, mat, lo, hi, scale,
                                                   accumulate);
  return (int)cudaGetLastError();
}

int srcfd_mg_col_transfer(const float* in, float* out, int n, int m_in,
                          int m_out, const float* mat_t, const int* lo,
                          const int* hi, float scale, int accumulate,
                          void* stream) {
  mg_col_transfer_kernel<<<srcfd_grid(n, m_out), dim3(SRCFD_TX, SRCFD_TY), 0,
                           (cudaStream_t)stream>>>(in, out, n, m_in, m_out,
                                                   mat_t, lo, hi, scale,
                                                   accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"
