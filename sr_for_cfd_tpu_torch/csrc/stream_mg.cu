// The staged form of the streamed V-cycle's fine-level passes: pass A
// (pre-smoothing with the entry residual, residual, restriction) and pass
// B (prolongation, the correction, post-smoothing) as one launch per stage.
//
// The passes replace the TPU kernels sr_for_cfd_tpu/ops/pallas_stream.py
// :168 (_pass_a_kernel, pallas_call :481) and :332 (_pass_b_kernel,
// pallas_call :521). On the card each pass is one launch of stream_pass.cu's
// fused kernel, whose note gives the passes' bound; this staged form is its
// bit-equality reference (ops/stream_kernels.py: stream_pass_a_staged,
// stream_pass_b_staged) and serves an n_pre or n_post past the fused
// kernel's halo. The level-1 correction between the passes is the TPU's
// _coarse_kernel :298, ported as ops/stream_kernels.py:level1_correction on
// mg_vcycle.cu.
//
// Design. One launch per stage covers the whole level with one thread per
// cell (per coarse cell for the restriction): mg_vcycle.cu's stages on the
// fine level (in-place red-black half-sweeps x += r * (sor / ap), the
// reciprocal form of pallas_stream.py:188-189 and :348-349; the banded
// column restriction; pass B's [0.75, 0.25] row prolongation with edge
// replication, added to x) plus the two kernels here, which do what those
// stages do not:
//   * sm_entry_half: pass A's first (red) half-sweep, out of place (the
//     black cells are copied), which also writes per-block sums of r^2 over
//     every interior cell before any update -- the entry residual, which
//     is the loop's convergence measure;
//   * sm_restrict_rows: the residual after the pre-smoothing and the
//     unnormalized [1,3,3,1] stride-2 row restriction in one pass, times
//     the per-row norms of _row_restrict_norm (scale/8 inside, scale/7 on
//     the two boundary rows); on a level that keeps its rows, the residual
//     times the restriction scale.
// Semi-coarsened levels skip the identity direction, as the plan says.
// At 2048^2 with n_pre = n_post = 4 pass A is 11 launches and pass B 9,
// each a trip over the level (~0.45 GB for pass A).
// No kernel waits on another; the host loop is bounded by max_cycles.

#include "common.cuh"
#include "mg_ops.cuh"

// the red half-sweep xin -> xout (black cells copied) with
// partials[block] = the sum of r^2 over the block's cells, taken from xin
__global__ void __launch_bounds__(SRCFD_THREADS)
sm_entry_half_kernel(const float* __restrict__ xin, float* __restrict__ xout,
                     const float* __restrict__ b, int n, int m, float inv_dx2,
                     float inv_dy2, float volp, float inv_ap,
                     float* __restrict__ partials) {
  __shared__ float sh[SRCFD_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float r2 = 0.0f;
  if (i < n && j < m) {
    const int idx = i * m + j;
    const float r = b[idx] - mg_lap(xin, i, j, n, m, inv_dx2, inv_dy2, volp);
    r2 = r * r;
    xout[idx] = ((i + j) & 1) == 0 ? xin[idx] + r * inv_ap : xin[idx];
  }
  const float s = srcfd_block_sum(r2, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// out (nc, m) = the restricted residual rows of level (nf, m); with
// coarsen_x == 0, nc == nf and out = r * norm_in
__global__ void __launch_bounds__(SRCFD_THREADS)
sm_restrict_rows_kernel(const float* __restrict__ x, const float* __restrict__ b,
                        float* __restrict__ out, int nf, int m, int nc,
                        float inv_dx2, float inv_dy2, float volp, int coarsen_x,
                        float norm_in, float norm_bd) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int I = blockIdx.y * blockDim.y + threadIdx.y;
  if (I >= nc || j >= m) return;
  if (!coarsen_x) {
    const float r = b[I * m + j] - mg_lap(x, I, j, nf, m, inv_dx2, inv_dy2, volp);
    out[I * m + j] = r * norm_in;
    return;
  }
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int g = 2 * I - 1 + k;
    t[k] = (g >= 0 && g < nf)
               ? b[g * m + j] - mg_lap(x, g, j, nf, m, inv_dx2, inv_dy2, volp)
               : 0.0f;
  }
  float u = t[0] + 3.0f * t[1];
  u = u + 3.0f * t[2];
  u = u + t[3];
  out[I * m + j] = u * ((I == 0 || I == nc - 1) ? norm_bd : norm_in);
}

extern "C" {

// the partials count is srcfd_mg_partials's (the same grid)
int srcfd_sm_entry_half(const float* xin, float* xout, const float* b, int n,
                        int m, float inv_dx2, float inv_dy2, float volp,
                        float inv_ap, float* partials, void* stream) {
  sm_entry_half_kernel<<<srcfd_grid(n, m), dim3(SRCFD_TX, SRCFD_TY), 0,
                         (cudaStream_t)stream>>>(xin, xout, b, n, m, inv_dx2,
                                                 inv_dy2, volp, inv_ap,
                                                 partials);
  return (int)cudaGetLastError();
}

int srcfd_sm_restrict_rows(const float* x, const float* b, float* out, int nf,
                           int m, int nc, float inv_dx2, float inv_dy2,
                           float volp, int coarsen_x, float norm_in,
                           float norm_bd, void* stream) {
  sm_restrict_rows_kernel<<<srcfd_grid(nc, m), dim3(SRCFD_TX, SRCFD_TY), 0,
                            (cudaStream_t)stream>>>(x, b, out, nf, m, nc,
                                                    inv_dx2, inv_dy2, volp,
                                                    coarsen_x, norm_in,
                                                    norm_bd);
  return (int)cudaGetLastError();
}

}  // extern "C"
