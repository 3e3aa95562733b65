// Red-black SOR pressure loop for volp * Laplacian(p) = b with frozen ghosts.
//
// Replaces the TPU kernel sr_for_cfd_tpu/ops/pallas_kernels.py:136
// (pallas_solve_pressure; kernel body _pressure_kernel at :47), which keeps
// the padded field in VMEM for the whole loop.
//
// Bound. A sweep reads p (5 neighbours, served from cache) and b and writes
// p: about 12 bytes per cell, 1.9 MB at 402x402, which sits in the 50 MB
// L2; at 3.35 TB/s of device memory that is ~0.6 us per sweep, below the
// ~2-3 us it costs to launch a kernel. So the large-grid path is bound by
// launch latency and L2 bandwidth, and the 12x12 coarse grid of the hybrid
// (144 cells) by launch latency alone.
//
// Design.
// * Large grids: one launch per half-sweep over the padded field, one
//   thread per cell; parity (i+j)%2 in padded coordinates. A cell of one
//   colour reads only cells of the other colour and itself, so updating in
//   place gives exactly the TPU kernel's "residual at the start of the half"
//   semantics. On a check sweep every block writes the sum of its r^2 to a
//   partials array; srcfd_rms_finalize sums the partials in a fixed order
//   (no atomics), so exit decisions repeat bit for bit. The host reads the
//   rms once per check and applies the stall policy.
// * Small grids (the whole padded field and RHS fit in 48 KB of shared
//   memory): one block runs the entire loop, stall policy included, with
//   __syncthreads() between half-sweeps: one launch per pressure solve.
//   One block never waits on another.
// Every loop is bounded by max_iter (sweeps) passed in by the wrapper.
// The stall policy's constants come from the wrapper too (ops/sweeps.py
// owns them), so the single-block loop exits where the host loop does.

#include <math.h>

#include "rb_ops.cuh"

__global__ void __launch_bounds__(SRCFD_THREADS)
rb_half_sweep_kernel(float* __restrict__ p, const float* __restrict__ b,
                     float* __restrict__ partials, int nx2, int ny2, RbCoef c,
                     int color, int with_rms) {
  __shared__ float sh[SRCFD_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int i = blockIdx.y * blockDim.y + threadIdx.y + 1;
  float r2 = 0.0f;
  if (i <= nx2 - 2 && j <= ny2 - 2 && ((i + j) & 1) == color) {
    const int idx = i * ny2 + j;
    const float r = rb_residual(p, b, idx, ny2, c);
    p[idx] = p[idx] + rb_step(r, c);
    r2 = r * r;
  }
  if (with_rms) {  // uniform over the block
    const float s = srcfd_block_sum(r2, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// rms = sqrt(sum(partials) / n_cells), summed in a fixed order by one block;
// shard_rb.cu's tiled sweeps are finished by it too (srcfd_rms_finalize)
__global__ void __launch_bounds__(SRCFD_THREADS)
rms_finalize_kernel(const float* __restrict__ partials, int n, float n_cells,
                    float* __restrict__ out) {
  __shared__ float sh[SRCFD_THREADS];
  const float s = srcfd_fixed_sum(partials, n, sh);
  if (threadIdx.x == 0) out[0] = sqrtf(s / n_cells);
}

__global__ void __launch_bounds__(SRCFD_THREADS)
rb_sor_loop_small_kernel(float* __restrict__ p_g, const float* __restrict__ b_g,
                         int nx2, int ny2, RbCoef c, StallPolicy sp, float tol,
                         int max_iter, int check_every,
                         int* __restrict__ count_out,
                         float* __restrict__ rms_out) {
  extern __shared__ float smem[];
  __shared__ float sh[SRCFD_THREADS];
  float* p = smem;
  float* b = smem + nx2 * ny2;
  const int n = nx2 * ny2;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    p[k] = p_g[k];
    b[k] = b_g[k];
  }
  __syncthreads();
  const int ny = ny2 - 2;
  const int n_cells = (nx2 - 2) * ny;
  // every thread carries the same loop state (it is computed from the same
  // block sums), so all threads take the same branches and reach the same
  // __syncthreads()
  float rms = INFINITY, best = INFINITY;
  int stale = 0, checks = 0, it = 0;
  while (it < max_iter && rms >= tol && !stalled(stale, checks, sp)) {
    float acc = 0.0f;
    for (int s = 0; s < check_every; ++s) {
      const bool last = s == check_every - 1;
      for (int color = 0; color < 2; ++color) {
        for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
          const int i = k / ny + 1, j = k % ny + 1;
          if (((i + j) & 1) != color) continue;
          const int idx = i * ny2 + j;
          const float r = rb_residual(p, b, idx, ny2, c);
          p[idx] = p[idx] + rb_step(r, c);
          if (last) acc += r * r;
        }
        __syncthreads();
      }
    }
    const float now = sqrtf(srcfd_block_sum(acc, sh) / (float)n_cells);
    stall_update(now, rms, best, stale, sp);
    rms = now;
    checks += 1;
    it += check_every;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) p_g[k] = p[k];
  if (threadIdx.x == 0) {
    count_out[0] = it;
    rms_out[0] = rms;
  }
}

static dim3 rb_grid(int nx2, int ny2) {
  return dim3((ny2 - 2 + SRCFD_TX - 1) / SRCFD_TX,
              (nx2 - 2 + SRCFD_TY - 1) / SRCFD_TY);
}

extern "C" {

// number of partial sums one half-sweep writes
int srcfd_rb_partials(int nx2, int ny2) {
  const dim3 g = rb_grid(nx2, ny2);
  return (int)(g.x * g.y);
}

// largest padded cell count the single-block loop takes
int srcfd_rb_small_max_cells(void) {
  // 48 KB of shared memory without opting in, less the reduction scratch
  return (46 * 1024) / (2 * (int)sizeof(float));
}

int srcfd_rb_half_sweep(float* p, const float* b, float* partials, int nx2,
                        int ny2, float inv_dx2, float inv_dy2, float volp,
                        float sor, float inv_ap, float ap_d, int divide,
                        int color, int with_rms, void* stream) {
  const RbCoef c{inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d, divide};
  rb_half_sweep_kernel<<<rb_grid(nx2, ny2), dim3(SRCFD_TX, SRCFD_TY), 0,
                         (cudaStream_t)stream>>>(p, b, partials, nx2, ny2, c,
                                                 color, with_rms);
  return (int)cudaGetLastError();
}

int srcfd_rms_finalize(const float* partials, int n, float n_cells, float* out,
                       void* stream) {
  rms_finalize_kernel<<<1, SRCFD_THREADS, 0, (cudaStream_t)stream>>>(
      partials, n, n_cells, out);
  return (int)cudaGetLastError();
}

int srcfd_rb_sor_loop_small(float* p, const float* b, int nx2, int ny2,
                            float inv_dx2, float inv_dy2, float volp, float sor,
                            float inv_ap, float ap_d, int divide,
                            float stall_reset_ratio,
                            float stall_ratio, int stall_patience,
                            int stall_min_checks, float tol, int max_iter,
                            int check_every, int* count_out, float* rms_out,
                            void* stream) {
  const RbCoef c{inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d, divide};
  const StallPolicy sp{stall_reset_ratio, stall_ratio, stall_patience,
                       stall_min_checks};
  const size_t smem = 2 * (size_t)nx2 * ny2 * sizeof(float);
  rb_sor_loop_small_kernel<<<1, SRCFD_THREADS, smem, (cudaStream_t)stream>>>(
      p, b, nx2, ny2, c, sp, tol, max_iter, check_every, count_out, rms_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
