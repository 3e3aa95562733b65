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
// * Middle grids (the whole padded field and RHS fit in 48 KB of shared
//   memory): one block runs the entire loop, stall policy included, with
//   __syncthreads() between half-sweeps: one launch per pressure solve.
//   One block never waits on another.
// * Small grids (at most RB_WARP_MAX padded rows and columns: the hybrid's
//   10x10 and 20x20 coarse grids): one warp runs the entire loop, from the
//   face fluxes: it builds b = (((e + n) + w) + s) * float32(rho / dt) as
//   the plain path rounds it, so the wrapper launches nothing else. A lane
//   owns a padded column, its rows in registers (caps 12, 22 and 32: the
//   two coarse grids and the largest); j +- 1 come by one shuffle each,
//   i +- 1 from the lane's own registers; no barrier, no division per
//   cell. A half-sweep takes the rows in pairs, in which each lane has one
//   cell of the colour (the lower row on one parity of j, the upper on the
//   other): every pair's residual from the values before the half, then
//   the updates by a select (a cell reads only the other colour: the
//   in-place semantics), no residual worked out for a cell it does not
//   update. The rms keeps the single-block loop's bits: the check's last
//   sweep writes r^2 to shared memory at k = (i-1)*ny + (j-1); slot t of
//   256 sums the red, then the black cells of k = t mod 256 in increasing
//   k (what thread t of the block loop adds), lane l holds slots l + 32m,
//   and srcfd_block_sum's tree runs as adds in the lane (steps 128..32)
//   and shuffles (16..1). One warp has nothing to hide latency behind:
//   each half-sweep waits on the last one's updates through a shuffle and
//   ~10 dependent float operations.
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

#define RB_WARP_MAX 32  // padded rows / columns of the one-warp loop
#define RB_WARP_CELLS ((RB_WARP_MAX - 2) * (RB_WARP_MAX - 2))
#define RB_FULL 0xffffffffu

// The one-warp loop's settings; ops/pressure_kernels.py's Params mirrors
// this layout and srcfd_rb_warp_params_size lets it check it.
struct RbWarpParams {
  int nx2, ny2;
  RbCoef c;
  StallPolicy sp;
  float rhodt, tol;
  int max_iter, check_every;
};

// The whole loop in one warp (see the header). Lane j holds padded column
// j, rows 0..ROWS-1 in f (ROWS >= nx2, even); the interior fluxes e, n, w,
// s are (nx, ny) row-major. p is read, p_out written (ghosts copied), the
// sweeps run and the last rms's bits written to state[0..1] (mapped host
// memory, read after the stream is synchronised).
// Every pair of rows up to ROWS is worked out, those past nx masked, and
// the update mode is a template argument: a half-sweep is one branch-free
// stretch of code that the compiler can interleave.
template <int ROWS, int MODE>
__global__ void __launch_bounds__(32)
rb_sor_warp_kernel(const RbWarpParams a, const float* __restrict__ p_g,
                   float* __restrict__ p_out, const float* __restrict__ fe,
                   const float* __restrict__ fn, const float* __restrict__ fw,
                   const float* __restrict__ fs, int* __restrict__ state) {
  constexpr int NP = ROWS / 2 - 1;  // row pairs (i, i + 1), i = 1, 3, ...
  __shared__ float r2s[RB_WARP_CELLS];
  const int nx2 = a.nx2, ny2 = a.ny2, max_iter = a.max_iter;
  const int check_every = a.check_every;
  const float rhodt = a.rhodt, tol = a.tol;
  const RbCoef& c = a.c;
  const StallPolicy& sp = a.sp;
  const int j = threadIdx.x;
  const int nx = nx2 - 2, ny = ny2 - 2;
  const int n_cells = nx * ny;
  const bool col = j >= 1 && j <= ny;
  float f[ROWS], b[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    f[i] = (i < nx2 && j < ny2) ? p_g[i * ny2 + j] : 0.0f;
    b[i] = 0.0f;
    if (i >= 1 && i <= nx && col) {
      const int k = (i - 1) * ny + (j - 1);
      b[i] = (((fe[k] + fn[k]) + fw[k]) + fs[k]) * rhodt;
    }
  }
  // bit 4m + q: the colour of cell k = j + 32m + 256q (slot j + 32m)
  unsigned black = 0;
  for (int m = 0; m < 8; ++m)
    for (int q = 0; q < 4; ++q) {
      const int k = j + 32 * m + 256 * q;
      if (k < n_cells && ((k / ny + k % ny) & 1))
        black |= 1u << (4 * m + q);
    }
  // every lane carries the same loop state (from the same broadcast sum)
  float rms = INFINITY, best = INFINITY;
  int stale = 0, checks = 0, it = 0;
  while (it < max_iter && rms >= tol && !stalled(stale, checks, sp)) {
    for (int s = 0; s < check_every; ++s) {
#pragma unroll
      for (int colour = 0; colour < 2; ++colour) {
        // this lane's cell of the colour is row i of every pair (lo) or
        // row i + 1 of every pair, and its neighbours j +- 1 hold theirs
        // in the other row, the one this lane does not update; every
        // pair's residual first, from the values before the half, then
        // the updates
        const bool lo = ((j + 1) & 1) == colour;
        float r[NP], fc[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const int i = 2 * q + 1;
          const float other = lo ? f[i + 1] : f[i];
          const float f_n = __shfl_down_sync(RB_FULL, other, 1);
          const float f_s = __shfl_up_sync(RB_FULL, other, 1);
          fc[q] = lo ? f[i] : f[i + 1];
          r[q] = rb_residual_v(fc[q], lo ? f[i + 1] : f[i + 2], lo ? f[i - 1] : f[i],
                               f_n, f_s, lo ? b[i] : b[i + 1], c);
        }
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const int i = 2 * q + 1;
          const bool mine = col && (lo ? i : i + 1) <= nx;
          const float nv = fc[q] + rb_step_mode<MODE>(r[q], c);
          f[i] = (mine && lo) ? nv : f[i];
          f[i + 1] = (mine && !lo) ? nv : f[i + 1];
        }
        if (s == check_every - 1) {
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            const int row = lo ? 2 * q + 1 : 2 * q + 2;
            if (col && row <= nx) r2s[(row - 1) * ny + (j - 1)] = r[q] * r[q];
          }
        }
      }
    }
    __syncwarp();
    // the block loop's per-thread sums (red cells, then black, increasing
    // k) and srcfd_block_sum's tree
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int colour = 0; colour < 2; ++colour)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = j + 32 * m + 256 * q;
          if (k < n_cells && (int)((black >> (4 * m + q)) & 1u) == colour)
            acc += r2s[k];
        }
      v[m] = acc;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] += v[m + 4];  // step 128
    v[0] += v[2];                                    // step 64
    v[1] += v[3];
    v[0] += v[1];                                    // step 32
    float sum = v[0];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(RB_FULL, sum, d);
    sum = __shfl_sync(RB_FULL, sum, 0);
    const float now = sqrtf(sum / (float)n_cells);
    stall_update(now, rms, best, stale, sp);
    rms = now;
    checks += 1;
    it += check_every;
    __syncwarp();  // r2s is written again by the next check
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (i < nx2 && j < ny2) p_out[i * ny2 + j] = f[i];
  if (j == 0) {
    state[0] = it;
    state[1] = __float_as_int(rms);
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

// wait for the work queued on `stream` (the one-warp loop's caller reads
// the count and rms it wrote to mapped host memory after it)
int srcfd_stream_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
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

int srcfd_rb_warp_params_size(void) { return (int)sizeof(RbWarpParams); }

int srcfd_rb_sor_warp(const RbWarpParams* prm, const float* p, float* p_out,
                      const float* fe, const float* fn, const float* fw,
                      const float* fs, int* state, void* stream) {
  const RbWarpParams a = *prm;
  if (a.nx2 < 3 || a.ny2 < 3 || a.nx2 > RB_WARP_MAX || a.ny2 > RB_WARP_MAX ||
      a.check_every < 1 || a.c.mode < 0 || a.c.mode > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define RB_WARP_LAUNCH(R, M) \
  rb_sor_warp_kernel<R, M><<<1, 32, 0, st>>>(a, p, p_out, fe, fn, fw, fs, state)
#define RB_WARP_ROWS(M)          \
  if (a.nx2 <= 12)               \
    RB_WARP_LAUNCH(12, M);       \
  else if (a.nx2 <= 22)          \
    RB_WARP_LAUNCH(22, M);       \
  else                           \
    RB_WARP_LAUNCH(RB_WARP_MAX, M)
  if (a.c.mode == 1)
    RB_WARP_ROWS(1);
  else
    RB_WARP_ROWS(0);
#undef RB_WARP_ROWS
#undef RB_WARP_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
