// Geometric-multigrid V-cycle pressure loop: stage kernels for the fine
// levels, one block for the coarse tail.
//
// Replaces the TPU kernel sr_for_cfd_tpu/ops/pallas_mg.py:415
// (pallas_mg_solve_pressure; body _mg_kernel at :391, loop mg_while_loop
// :348, level operators make_level_ops :232), which keeps the whole level
// hierarchy in VMEM and runs every cycle inside one launch, and the level-1
// correction of the streamed V-cycle (pallas_stream.py:298, _coarse_kernel).
//
// Bound. Every stage streams its level once: a smoother half-sweep reads x
// and b and writes x (~8 bytes per cell), the residual reads x and b and
// writes r, a transfer reads its input and writes its output. At 400x400
// (160,000 cells, 0.64 MB per array) one V-cycle (4+4 sweeps per level)
// moves roughly 40 MB over all levels -- ~12 us at 3.35 TB/s of device
// memory, and less, since the whole hierarchy (~3 MB) stays in the 50 MB
// L2. Issued one by one from the host, the ~200 stages of a cycle are bound
// by launch latency, not by bytes or arithmetic; the coarse levels, a few
// thousand cells each, hold most of those launches.
//
// Design. The stage kernels cover one level each:
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
// mg_tail_kernel runs the V-cycle from a coarse level t down to the
// coarsest and back in ONE block of 1,024 threads: every tail level's x, b,
// r and row/column scratch live in dynamic shared memory (at most
// MG_TAIL_SMEM_BUDGET bytes, allowed once by srcfd_mg_tail_init), the band
// matrices are read from global memory, and __syncthreads() separates the
// stages. The wrapper (ops/mg_kernels.py) picks t as the first level whose
// tail fits the budget, launches the stages above it, and captures the
// whole cycle -- stages, tail and fine rms -- into one CUDA graph that it
// replays once per cycle. Stage kernels and tail compute each cell with the
// same functions (mg_ops.cuh), so under -fmad=false the tail gives the bits
// of the stages it replaces.
// No kernel waits on another block; every loop is bounded by sizes or by
// max_cycles, which the wrapper passes in.

#include "common.cuh"
#include "mg_ops.cuh"

#define MG_TAIL_THREADS 1024
#define MG_TAIL_MAX_LEVELS 16
// bytes of dynamic shared memory the tail's level arrays may take, under
// the 227 KB a block can have (ops/mg_kernels.py TAIL_SMEM_BUDGET)
#define MG_TAIL_SMEM_BUDGET (160 * 1024)

__global__ void __launch_bounds__(SRCFD_THREADS)
mg_smooth_half_kernel(float* __restrict__ x, const float* __restrict__ b, int n,
                      int m, float inv_dx2, float inv_dy2, float volp,
                      float inv_ap, int color) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m || ((i + j) & 1) != color) return;
  x[i * m + j] = mg_smoothed_at(x, b, i, j, n, m, inv_dx2, inv_dy2, volp, inv_ap);
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
    const float r = mg_residual_at(x, b, i, j, n, m, inv_dx2, inv_dy2, volp);
    if (r_out != nullptr) r_out[i * m + j] = r;
    r2 = r * r;
  }
  if (partials != nullptr) {  // uniform over the block
    const float s = srcfd_block_sum(r2, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// out[I, j] = mg_row_value(...) * scale, or out += with accumulate
__global__ void __launch_bounds__(SRCFD_THREADS)
mg_row_transfer_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int n_in, int n_out, int m, int mode,
                       const float* __restrict__ mat, const int* __restrict__ lo,
                       const int* __restrict__ hi, float scale, int accumulate) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int I = blockIdx.y * blockDim.y + threadIdx.y;
  if (I >= n_out || j >= m) return;
  mg_transfer_store(out, I * m + j,
                    mg_row_value(in, I, j, n_in, n_out, m, mode, mat, lo, hi),
                    scale, accumulate);
}

// out[i, J] = mg_col_value(...) * scale, or out += with accumulate
__global__ void __launch_bounds__(SRCFD_THREADS)
mg_col_transfer_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int n, int m_in, int m_out,
                       const float* __restrict__ mat_t, const int* __restrict__ lo,
                       const int* __restrict__ hi, float scale, int accumulate) {
  const int J = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || J >= m_out) return;
  mg_transfer_store(out, i * m_out + J,
                    mg_col_value(in, i, J, m_in, m_out, mat_t, lo, hi), scale,
                    accumulate);
}

// ---- the coarse tail: one block, every level in shared memory ----------

// One tail level and its transition to the next (unused on the coarsest).
struct MgTailLevel {
  int n, m;
  int row_mode;        // MG_ROW_BAND or MG_ROW_RESTRICT_2X; -1: rows kept
  int has_col;         // columns coarsened
  int x, b, r, tmp;    // offsets (floats) into the dynamic shared memory
  float inv_dx2, inv_dy2, volp;
  float inv_ap;        // the smoother's omega / ap (omega 1.5 on the coarsest)
  float scale;         // restriction scale
  const float* rr;     // row restriction band (MG_ROW_BAND)
  const int* rr_lo;
  const int* rr_hi;
  const float* rp;     // row prolongation band (MG_ROW_BAND)
  const int* rp_lo;
  const int* rp_hi;
  const float* cr;     // column restriction band (has_col)
  const int* cr_lo;
  const int* cr_hi;
  const float* cp;     // column prolongation band (has_col)
  const int* cp_lo;
  const int* cp_hi;
};

struct MgTailPlan {
  int n_levels, n_pre, n_post, coarsest_sweeps;
  MgTailLevel lv[MG_TAIL_MAX_LEVELS];
};

// n_sweeps red-black sweeps, in place; thread k of a half-sweep takes the
// k-th cell of that colour
__device__ void tail_smooth(float* sm, const MgTailLevel& L, int n_sweeps) {
  float* x = sm + L.x;
  const float* b = sm + L.b;
  const int n = L.n, m = L.m, hm = (m + 1) >> 1, cells = n * hm;
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      for (int k = threadIdx.x; k < cells; k += blockDim.x) {
        const int i = k / hm;
        const int j = 2 * (k - i * hm) + ((i + color) & 1);
        if (j < m)
          x[i * m + j] = mg_smoothed_at(x, b, i, j, n, m, L.inv_dx2, L.inv_dy2,
                                        L.volp, L.inv_ap);
      }
      __syncthreads();
    }
  }
}

// r = b - A x at level L, b(N) = (R r Rc^T) * scale, x(N) = 0
__device__ void tail_restrict(float* sm, const MgTailLevel& L,
                              const MgTailLevel& N) {
  const int n = L.n, m = L.m;
  const float* x = sm + L.x;
  const float* b = sm + L.b;
  float* r = sm + L.r;
  for (int k = threadIdx.x; k < n * m; k += blockDim.x) {
    const int i = k / m;
    r[k] = mg_residual_at(x, b, i, k - i * m, n, m, L.inv_dx2, L.inv_dy2, L.volp);
  }
  __syncthreads();
  const float* src = r;
  float* bc = sm + N.b;
  if (L.row_mode >= 0) {
    float* dst = L.has_col ? sm + L.tmp : bc;
    const float s = L.has_col ? 1.0f : L.scale;
    for (int k = threadIdx.x; k < N.n * m; k += blockDim.x) {
      const int I = k / m;
      mg_transfer_store(dst, k,
                        mg_row_value(src, I, k - I * m, n, N.n, m, L.row_mode,
                                     L.rr, L.rr_lo, L.rr_hi),
                        s, 0);
    }
    __syncthreads();
    src = dst;
  }
  if (L.has_col) {
    for (int k = threadIdx.x; k < N.n * N.m; k += blockDim.x) {
      const int i = k / N.m;
      mg_transfer_store(bc, k,
                        mg_col_value(src, i, k - i * N.m, m, N.m, L.cr, L.cr_lo,
                                     L.cr_hi),
                        L.scale, 0);
    }
  }
  float* xc = sm + N.x;
  for (int k = threadIdx.x; k < N.n * N.m; k += blockDim.x) xc[k] = 0.0f;
  __syncthreads();
}

// x(L) += P_row e Pc^T, e = x(N)
__device__ void tail_prolong_add(float* sm, const MgTailLevel& L,
                                 const MgTailLevel& N) {
  const int m = L.m;
  const float* src = sm + N.x;
  float* xf = sm + L.x;
  if (L.has_col) {
    float* dst = L.row_mode >= 0 ? sm + L.tmp : xf;
    const int acc = L.row_mode < 0;
    for (int k = threadIdx.x; k < N.n * m; k += blockDim.x) {
      const int i = k / m;
      mg_transfer_store(dst, k,
                        mg_col_value(src, i, k - i * m, N.m, m, L.cp, L.cp_lo,
                                     L.cp_hi),
                        1.0f, acc);
    }
    __syncthreads();
    src = dst;
  }
  if (L.row_mode >= 0) {
    const int mode = L.row_mode == MG_ROW_BAND ? MG_ROW_BAND : MG_ROW_PROLONG_2X;
    for (int k = threadIdx.x; k < L.n * m; k += blockDim.x) {
      const int I = k / m;
      mg_transfer_store(xf, k,
                        mg_row_value(src, I, k - I * m, N.n, L.n, m, mode, L.rp,
                                     L.rp_lo, L.rp_hi),
                        1.0f, 1);
    }
    __syncthreads();
  }
}

// One V-cycle on the tail levels: x_g and b_g are level t's arrays in
// global memory (x_g read and written back).
__global__ void __launch_bounds__(MG_TAIL_THREADS, 1)
mg_tail_kernel(float* __restrict__ x_g, const float* __restrict__ b_g,
               const MgTailPlan plan) {
  extern __shared__ float sm[];
  __shared__ MgTailLevel lv[MG_TAIL_MAX_LEVELS];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < MG_TAIL_MAX_LEVELS; ++k) lv[k] = plan.lv[k];
  }
  __syncthreads();
  const int last = plan.n_levels - 1;
  const int cells = lv[0].n * lv[0].m;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    sm[lv[0].x + k] = x_g[k];
    sm[lv[0].b + k] = b_g[k];
  }
  __syncthreads();
  for (int k = 0; k < last; ++k) {
    tail_smooth(sm, lv[k], plan.n_pre);
    tail_restrict(sm, lv[k], lv[k + 1]);
  }
  tail_smooth(sm, lv[last], plan.coarsest_sweeps);
  for (int k = last - 1; k >= 0; --k) {
    tail_prolong_add(sm, lv[k], lv[k + 1]);
    tail_smooth(sm, lv[k], plan.n_post);
  }
  for (int k = threadIdx.x; k < cells; k += blockDim.x) x_g[k] = sm[lv[0].x + k];
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

// x[0..n) = 0 (a memset, as a graph node when captured)
int srcfd_mg_zero(float* x, int n, void* stream) {
  return (int)cudaMemsetAsync(x, 0, sizeof(float) * (size_t)n,
                              (cudaStream_t)stream);
}

// allows the tail its dynamic shared memory; called once when the library
// is loaded, before any launch or capture
int srcfd_mg_tail_init() {
  return (int)cudaFuncSetAttribute(mg_tail_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MG_TAIL_SMEM_BUDGET);
}

// One tail V-cycle on n_levels levels. Per level k the host arrays give
// iprm[8k..8k+8): n, m, row_mode, has_col and the x, b, r, tmp offsets;
// fprm[5k..5k+5): inv_dx2, inv_dy2, volp, inv_ap, scale; pprm[12k..12k+12):
// the row restriction, row prolongation, column restriction and column
// prolongation bands, each as (mat, lo, hi), null where unused. The plan is
// copied into the launch's parameters, so a captured launch keeps it.
int srcfd_mg_tail(float* x, const float* b, int n_levels, const int* iprm,
                  const float* fprm, const void* const* pprm, int n_pre,
                  int n_post, int coarsest_sweeps, int smem_bytes,
                  void* stream) {
  if (n_levels < 1 || n_levels > MG_TAIL_MAX_LEVELS || smem_bytes < 0 ||
      smem_bytes > MG_TAIL_SMEM_BUDGET)
    return (int)cudaErrorInvalidValue;
  MgTailPlan plan = {};
  plan.n_levels = n_levels;
  plan.n_pre = n_pre;
  plan.n_post = n_post;
  plan.coarsest_sweeps = coarsest_sweeps;
  for (int k = 0; k < n_levels; ++k) {
    const int* ip = iprm + 8 * k;
    const float* fp = fprm + 5 * k;
    const void* const* pp = pprm + 12 * k;
    MgTailLevel& L = plan.lv[k];
    L.n = ip[0];
    L.m = ip[1];
    L.row_mode = ip[2];
    L.has_col = ip[3];
    L.x = ip[4];
    L.b = ip[5];
    L.r = ip[6];
    L.tmp = ip[7];
    L.inv_dx2 = fp[0];
    L.inv_dy2 = fp[1];
    L.volp = fp[2];
    L.inv_ap = fp[3];
    L.scale = fp[4];
    L.rr = (const float*)pp[0];
    L.rr_lo = (const int*)pp[1];
    L.rr_hi = (const int*)pp[2];
    L.rp = (const float*)pp[3];
    L.rp_lo = (const int*)pp[4];
    L.rp_hi = (const int*)pp[5];
    L.cr = (const float*)pp[6];
    L.cr_lo = (const int*)pp[7];
    L.cr_hi = (const int*)pp[8];
    L.cp = (const float*)pp[9];
    L.cp_lo = (const int*)pp[10];
    L.cp_hi = (const int*)pp[11];
  }
  mg_tail_kernel<<<1, MG_TAIL_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      x, b, plan);
  return (int)cudaGetLastError();
}

}  // extern "C"
