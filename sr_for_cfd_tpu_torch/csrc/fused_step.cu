// Whole SIMPLE outer steps: momentum red-black loops, relaxation, boundary
// fills (BFS inlet included), face fluxes, pressure, projection, residual
// sums and the Rhie-Chow flux update.
//
// Replaces the TPU kernel sr_for_cfd_tpu/ops/pallas_step.py:414
// (pallas_simple_step; kernel body make_step_kernel :82, pallas_call :454),
// which keeps every field in VMEM and runs K whole steps in one launch.
//
// Bound. A step is a few dozen stencil sweeps over a handful of fields:
// ~30-60 float32 operations and ~8-12 bytes of device memory per cell and
// sweep. At 12x12 (the hybrid's coarse grid) that is ~1e5 operations per
// step, nanoseconds at 67 TFLOP/s: the step is bound by latency -- launches,
// barriers and host round trips -- not by bytes or arithmetic. At 400x400
// a sweep moves ~2 MB, which stays in the 50 MB L2; with ~100-200 launches
// per step it is bound by launch latency too.
//
// Design (a), srcfd_step_small_batched: one block runs K whole steps of a
// case with every field in shared memory (12 padded arrays: 6.9 KB at
// 12x12, at most 227 KB), synchronising with __syncthreads() only. One
// launch per K steps; the host reads res[3] and counts[3] once per launch.
// All threads carry the same loop state (it is computed from block sums),
// so they take the same branches and reach the same barriers. Every loop
// is bounded by K, max_iter (inner sweeps) or a size. The launch runs a
// case axis, one block per listed case, each with its own nu (the
// data-generation sweep's vmapped pallas_call): at 10x10 or 50x50 a block
// holds one SM's shared memory, so n cases take one launch on n SMs where
// a loop over the cases takes n launches on one. A solver's single case is
// the same launch with no list: one block, case 0.
//
// Design (b), for grids past (a)'s shared memory and for the multigrid
// pressure mode: each momentum loop on the fused momentum pass
// (mom_pass.cu: a check's sweeps and its residual sum in one launch, the
// loop's exit on the card); srcfd_step_relax_bc (relaxation and the
// boundary fill of one field in one launch, out of place),
// srcfd_step_fluxes, the pressure stage (rb_sor.cu or mg_vcycle.cu through
// their wrappers) and srcfd_step_project_bc (projection, Rhie-Chow, the
// three residual sums and the ring fills of u and v in one launch: its
// last block, behind a ticket, sums and fills). Five launches a step
// besides the loops. The staged form (the card gates' bit-equality
// reference) keeps a launch per stage: srcfd_step_mom_half (one red-black
// half-sweep, out of place because QUICK reads same-colour cells two
// away; optional per-block r^2 sums) with srcfd_rms_finalize (rb_sor.cu)
// and a host read per check, srcfd_step_relax, srcfd_step_bc,
// srcfd_step_project and srcfd_step_sums. No block waits on another.
//
// Arithmetic follows the TPU kernel operation by operation (the library is
// built with -fmad=false, so no multiply-add is contracted): the momentum
// update divides by its diagonal, the pressure update is (sor * r) / ap_d.

#include <math.h>

#include "common.cuh"
#include "momentum.cuh"

// Mirrored field by field by ops/step_kernels.py:StepParams (ctypes); every
// field is 4 bytes, so the two layouts agree without padding.
struct StepParams {
  int nx2, ny2;  // padded shape, ny2 contiguous
  int quick;     // 1: QUICK convection, 0: first-order upwind
  int k_steps;
  int max_iter, m_check, p_check;
  int stall_patience, stall_min_checks;
  float stall_reset_ratio, stall_ratio;
  float tol;
  float volp, volp_dt, inv_dx2, inv_dy2, ap_d;
  float sor;  // point-iteration omega, clamped to the grid's optimum
  float alpha_u, alpha_v, alpha_p;
  float half_dx, half_dy, rho_dt;
  float c_dt_rho, two_dx, two_dy, dx, dy;
  int bc_type[12];     // [var * 4 + side], sides left, right, top, bottom:
  float bc_twice[12];  // 0 Dirichlet (ghost = 2 value - inside), 1 Neumann
  int bfs;             // the BFS inlet overrides the left ghosts of u, v
};

// pressure residual b - volp Laplacian(p) at padded index idx
__device__ __forceinline__ float p_residual(const float* __restrict__ p,
                                            const float* __restrict__ b,
                                            int idx, const StepParams& c) {
  const int ny2 = c.ny2;
  const float F = p[idx];
  const float fd = c.volp * (((p[idx + ny2] - 2.0f * F) + p[idx - ny2]) * c.inv_dx2 +
                             ((p[idx + 1] - 2.0f * F) + p[idx - 1]) * c.inv_dy2);
  return b[idx] - fd;
}

__device__ __forceinline__ int ring_cells(const StepParams& c) {
  return 2 * (c.nx2 - 2) + 2 * (c.ny2 - 2);
}

// the ghost value of ring side `side` (0 left i=0, 1 right i=nx+1, 2 top
// j=ny+1, 3 bottom j=0) of variable var (0 u, 1 v, 2 p) from its inside
// neighbour `in`; j is the ghost's column on the left side
__device__ __forceinline__ float bc_value(float in, int side, int j, int var,
                                          const StepParams& c,
                                          const float* __restrict__ u_in,
                                          const float* __restrict__ below) {
  float g = c.bc_type[var * 4 + side] == 0 ? c.bc_twice[var * 4 + side] - in : in;
  if (side == 0 && c.bfs && var < 2)
    g = (var == 1 || below[j] > 0.5f) ? -in : 2.0f * u_in[j] - in;
  return g;
}

// ghost k of the ring (left j=1..ny, right, top i=1..nx, bottom; corners
// untouched): its side, its index, its inside neighbour's index and, on
// the left, its column
__device__ __forceinline__ void ring_cell(int k, const StepParams& c, int& side,
                                          int& ghost, int& inside, int& j) {
  const int nx = c.nx2 - 2, ny = c.ny2 - 2, ny2 = c.ny2;
  j = 0;
  if (k < ny) {
    side = 0;
    j = k + 1;
    ghost = j;
    inside = ny2 + j;
  } else if (k < 2 * ny) {
    side = 1;
    j = k - ny + 1;
    ghost = (nx + 1) * ny2 + j;
    inside = nx * ny2 + j;
  } else if (k < 2 * ny + nx) {
    side = 2;
    const int i = k - 2 * ny + 1;
    ghost = i * ny2 + ny + 1;
    inside = i * ny2 + ny;
  } else {
    side = 3;
    const int i = k - 2 * ny - nx + 1;
    ghost = i * ny2;
    inside = i * ny2 + 1;
  }
}

// ghost k of the ring of variable var, from the interior only; kCg reads
// the inside cell through L2 (cells another block of the launch wrote)
template <bool kCg = false>
__device__ __forceinline__ void bc_cell(float* __restrict__ f, int k, int var,
                                        const StepParams& c,
                                        const float* __restrict__ u_in,
                                        const float* __restrict__ below) {
  int side, ghost, inside, j;
  ring_cell(k, c, side, ghost, inside, j);
  const float in = kCg ? __ldcg(f + inside) : f[inside];
  f[ghost] = bc_value(in, side, j, var, c, u_in, below);
}

__device__ __forceinline__ void stall_step(float now, const StepParams& c,
                                           float& rms, float& best, int& stale) {
  const bool new_best = now < c.stall_reset_ratio * best;
  const bool descending = now < c.stall_ratio * rms;
  stale = new_best ? 0 : (descending ? stale : stale + 1);
  best = (isnan(best) || isnan(now)) ? NAN : fminf(best, now);
  rms = now;
}

__device__ __forceinline__ bool inner_active(int it, int max_iter, float best,
                                             int stale, int checks,
                                             const StepParams& c) {
  return it < max_iter && best >= c.tol &&
         !(stale >= c.stall_patience && checks >= c.stall_min_checks);
}

// ---- design (a): one block, K steps in shared memory -------------------

// red-black momentum loop on f (f0 = the step-entry field); sr holds a
// half-sweep's increments, so that every residual of a colour is taken
// before any cell of it moves (QUICK reads same-colour cells two away)
__device__ int block_momentum(float* f, const float* f0, const float* fe,
                              const float* fn, const float* fw, const float* fs,
                              float* sr, float nu, const StepParams& c,
                              float* sh) {
  const int ny = c.ny2 - 2, n_cells = (c.nx2 - 2) * ny;
  float rms = INFINITY, best = INFINITY;
  int stale = 0, checks = 0, it = 0;
  while (inner_active(it, c.max_iter, best, stale, checks, c)) {
    float acc = 0.0f;
    for (int s = 0; s < c.m_check; ++s) {
      const bool last = s == c.m_check - 1;
      for (int color = 0; color < 2; ++color) {
        for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
          const int i = k / ny + 1, j = k % ny + 1;
          if (((i + j) & 1) != color) continue;
          const int idx = i * c.ny2 + j;
          float ap;
          const float r = srcfd_mom_residual(f, f0[idx], fe, fn, fw, fs, i, j, idx, nu, c, &ap);
          sr[idx] = r / ap;
          if (last) acc += r * r;
        }
        __syncthreads();
        for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
          const int i = k / ny + 1, j = k % ny + 1;
          if (((i + j) & 1) != color) continue;
          const int idx = i * c.ny2 + j;
          f[idx] = f[idx] + sr[idx];
        }
        __syncthreads();
      }
    }
    const float now = sqrtf(srcfd_block_sum(acc, sh) / (float)n_cells);
    stall_step(now, c, rms, best, stale);
    checks += 1;
    it += c.m_check;
  }
  return it;
}

// red-black SOR pressure loop in place (a cell reads only the other colour)
__device__ int block_pressure(float* p, const float* b, const StepParams& c,
                              float* sh) {
  const int ny = c.ny2 - 2, n_cells = (c.nx2 - 2) * ny;
  float rms = INFINITY, best = INFINITY;
  int stale = 0, checks = 0, it = 0;
  while (inner_active(it, c.max_iter, best, stale, checks, c)) {
    float acc = 0.0f;
    for (int s = 0; s < c.p_check; ++s) {
      const bool last = s == c.p_check - 1;
      for (int color = 0; color < 2; ++color) {
        for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
          const int i = k / ny + 1, j = k % ny + 1;
          if (((i + j) & 1) != color) continue;
          const int idx = i * c.ny2 + j;
          const float r = p_residual(p, b, idx, c);
          p[idx] = p[idx] + (c.sor * r) / c.ap_d;
          if (last) acc += r * r;
        }
        __syncthreads();
      }
    }
    const float now = sqrtf(srcfd_block_sum(acc, sh) / (float)n_cells);
    stall_step(now, c, rms, best, stale);
    checks += 1;
    it += c.p_check;
  }
  return it;
}

__device__ void block_relax(float* f, const float* f0, float alpha,
                            const StepParams& c) {
  if (alpha == 1.0f) return;  // uniform: the identity, skipped as the TPU kernel does
  const int ny = c.ny2 - 2, n_cells = (c.nx2 - 2) * ny;
  for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
    const int idx = (k / ny + 1) * c.ny2 + k % ny + 1;
    f[idx] = f0[idx] + alpha * (f[idx] - f0[idx]);
  }
}

__device__ void block_bc(float* f, int var, const StepParams& c,
                         const float* u_in, const float* below) {
  const int n = ring_cells(c);
  for (int k = threadIdx.x; k < n; k += blockDim.x) bc_cell(f, k, var, c, u_in, below);
}

// Design (a) over a case axis, the counterpart of JAX's vmapped
// pallas_call (the sweep's batched_cavity_solve): the fields are stacked
// (n, nx2, ny2), the fluxes (n, nx, ny), nu (n), res and counts (n, 3);
// block b runs case cases[b] (case 0 when cases is null) with every
// pointer offset by that case and the same body, so a case's result does
// not depend on the others. Cases not listed are not touched. The inlet
// profile is shared by all cases.
__global__ void __launch_bounds__(SRCFD_THREADS)
step_small_kernel(const float* __restrict__ u_g, const float* __restrict__ v_g,
                  const float* __restrict__ p_g, const float* __restrict__ fe_g,
                  const float* __restrict__ fn_g, const float* __restrict__ fw_g,
                  const float* __restrict__ fs_g, const float* __restrict__ u_in_g,
                  const float* __restrict__ below_g, const float* __restrict__ nu_g,
                  StepParams c, float* __restrict__ u_o, float* __restrict__ v_o,
                  float* __restrict__ p_o, float* __restrict__ fe_o,
                  float* __restrict__ fn_o, float* __restrict__ fw_o,
                  float* __restrict__ fs_o, float* __restrict__ res_o,
                  int* __restrict__ cnt_o, const int* __restrict__ cases) {
  extern __shared__ float smem[];
  __shared__ float sh[SRCFD_THREADS];
  const int nx2 = c.nx2, ny2 = c.ny2, nx = nx2 - 2, ny = ny2 - 2;
  const int N = nx2 * ny2, n_cells = nx * ny;
  {
    const long long b = cases != nullptr ? cases[blockIdx.x] : 0;
    const long long field = b * N, flux = b * n_cells;
    u_g += field;
    v_g += field;
    p_g += field;
    u_o += field;
    v_o += field;
    p_o += field;
    fe_g += flux;
    fn_g += flux;
    fw_g += flux;
    fs_g += flux;
    fe_o += flux;
    fn_o += flux;
    fw_o += flux;
    fs_o += flux;
    nu_g += b;
    res_o += 3 * b;
    cnt_o += 3 * b;
  }
  float* su = smem;
  float* sv = su + N;
  float* sp = sv + N;
  float* su0 = sp + N;
  float* sv0 = su0 + N;
  float* sp0 = sv0 + N;
  float* sfe = sp0 + N;  // padded, zero ghosts
  float* sfn = sfe + N;
  float* sfw = sfn + N;
  float* sfs = sfw + N;
  float* sb = sfs + N;
  float* sr = sb + N;
  float* s_uin = sr + N;
  float* s_below = s_uin + ny2;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    su[k] = u_g[k];
    sv[k] = v_g[k];
    sp[k] = p_g[k];
    const int i = k / ny2, j = k % ny2;
    const bool inner = i >= 1 && i <= nx && j >= 1 && j <= ny;
    const int q = (i - 1) * ny + (j - 1);
    sfe[k] = inner ? fe_g[q] : 0.0f;
    sfn[k] = inner ? fn_g[q] : 0.0f;
    sfw[k] = inner ? fw_g[q] : 0.0f;
    sfs[k] = inner ? fs_g[q] : 0.0f;
    sb[k] = 0.0f;
    sr[k] = 0.0f;
  }
  for (int k = threadIdx.x; k < ny2; k += blockDim.x) {
    s_uin[k] = c.bfs ? u_in_g[k] : 0.0f;
    s_below[k] = c.bfs ? below_g[k] : 0.0f;
  }
  const float nu = nu_g[0];
  __syncthreads();

  int cnt_u = 0, cnt_v = 0, cnt_p = 0;
  float res_u = 0.0f, res_v = 0.0f, res_p = 0.0f;
  for (int step = 0; step < c.k_steps; ++step) {
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      su0[k] = su[k];
      sv0[k] = sv[k];
      sp0[k] = sp[k];
    }
    __syncthreads();
    // momentum, relaxation, boundary fills
    cnt_u += block_momentum(su, su0, sfe, sfn, sfw, sfs, sr, nu, c, sh);
    block_relax(su, su0, c.alpha_u, c);
    __syncthreads();
    block_bc(su, 0, c, s_uin, s_below);
    __syncthreads();
    cnt_v += block_momentum(sv, sv0, sfe, sfn, sfw, sfs, sr, nu, c, sh);
    block_relax(sv, sv0, c.alpha_v, c);
    __syncthreads();
    block_bc(sv, 1, c, s_uin, s_below);
    __syncthreads();
    // face fluxes and the pressure right-hand side
    for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
      const int idx = (k / ny + 1) * ny2 + k % ny + 1;
      const float fe = (su[idx] + su[idx + ny2]) * c.half_dy;
      const float fw = -(su[idx] + su[idx - ny2]) * c.half_dy;
      const float fn = (sv[idx] + sv[idx + 1]) * c.half_dx;
      const float fs = -(sv[idx] + sv[idx - 1]) * c.half_dx;
      sfe[idx] = fe;
      sfn[idx] = fn;
      sfw[idx] = fw;
      sfs[idx] = fs;
      sb[idx] = c.rho_dt * (((fe + fn) + fw) + fs);
    }
    __syncthreads();
    cnt_p += block_pressure(sp, sb, c, sh);
    block_relax(sp, sp0, c.alpha_p, c);
    __syncthreads();
    block_bc(sp, 2, c, s_uin, s_below);
    __syncthreads();
    // projection, residual sums, Rhie-Chow
    float au = 0.0f, av = 0.0f, apr = 0.0f;
    for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
      const int idx = (k / ny + 1) * ny2 + k % ny + 1;
      const float pc = sp[idx];
      const float pe = sp[idx + ny2], pw = sp[idx - ny2];
      const float pn = sp[idx + 1], ps = sp[idx - 1];
      const float u = su[idx] - (c.c_dt_rho * (pe - pw)) / c.two_dx;
      const float v = sv[idx] - (c.c_dt_rho * (pn - ps)) / c.two_dy;
      su[idx] = u;
      sv[idx] = v;
      const float du = u - su0[idx], dv = v - sv0[idx], dp = pc - sp0[idx];
      au += du * du;
      av += dv * dv;
      apr += dp * dp;
      sfe[idx] = sfe[idx] - ((c.c_dt_rho * (pe - pc)) * c.dy) / c.dx;
      sfn[idx] = sfn[idx] - ((c.c_dt_rho * (pn - pc)) * c.dx) / c.dy;
      sfw[idx] = sfw[idx] - ((c.c_dt_rho * (pw - pc)) * c.dy) / c.dx;
      sfs[idx] = sfs[idx] - ((c.c_dt_rho * (ps - pc)) * c.dx) / c.dy;
    }
    res_u = srcfd_block_sum(au, sh);
    res_v = srcfd_block_sum(av, sh);
    res_p = srcfd_block_sum(apr, sh);
    block_bc(su, 0, c, s_uin, s_below);
    block_bc(sv, 1, c, s_uin, s_below);
    __syncthreads();
  }

  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    u_o[k] = su[k];
    v_o[k] = sv[k];
    p_o[k] = sp[k];
  }
  for (int k = threadIdx.x; k < n_cells; k += blockDim.x) {
    const int idx = (k / ny + 1) * ny2 + k % ny + 1;
    fe_o[k] = sfe[idx];
    fn_o[k] = sfn[idx];
    fw_o[k] = sfw[idx];
    fs_o[k] = sfs[idx];
  }
  if (threadIdx.x == 0) {
    res_o[0] = res_u;
    res_o[1] = res_v;
    res_o[2] = res_p;
    cnt_o[0] = cnt_u;
    cnt_o[1] = cnt_v;
    cnt_o[2] = cnt_p;
  }
}

// ---- design (b): one launch per stage ----------------------------------

__global__ void __launch_bounds__(SRCFD_THREADS)
step_relax_kernel(float* __restrict__ f, const float* __restrict__ f0, int nx2,
                  int ny2, float alpha) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int i = blockIdx.y * blockDim.y + threadIdx.y + 1;
  if (i > nx2 - 2 || j > ny2 - 2) return;
  const int idx = i * ny2 + j;
  f[idx] = f0[idx] + alpha * (f[idx] - f0[idx]);
}

__global__ void __launch_bounds__(SRCFD_THREADS)
step_bc_kernel(float* __restrict__ f, int var, StepParams c,
               const float* __restrict__ u_in, const float* __restrict__ below) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < ring_cells(c)) bc_cell(f, k, var, c, u_in, below);
}

__global__ void __launch_bounds__(SRCFD_THREADS)
step_fluxes_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   float* __restrict__ fe, float* __restrict__ fn,
                   float* __restrict__ fw, float* __restrict__ fs, StepParams c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int i = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int nx = c.nx2 - 2, ny = c.ny2 - 2, ny2 = c.ny2;
  if (i > nx || j > ny) return;
  const int idx = i * ny2 + j, q = (i - 1) * ny + (j - 1);
  fe[q] = (u[idx] + u[idx + ny2]) * c.half_dy;
  fw[q] = -(u[idx] + u[idx - ny2]) * c.half_dy;
  fn[q] = (v[idx] + v[idx + 1]) * c.half_dx;
  fs[q] = -(v[idx] + v[idx - 1]) * c.half_dx;
}

// projection of u, v (in place), per-block sums of (u-u0)^2, (v-v0)^2,
// (p-p0)^2 into partials[0|nb|2nb + block], Rhie-Chow on the fluxes: the
// body of step_project_kernel, on srcfd_grid(nx2 - 2, ny2 - 2)
__device__ __forceinline__ void project_cells(
    float* __restrict__ u, float* __restrict__ v, const float* __restrict__ p,
    const float* __restrict__ u0, const float* __restrict__ v0,
    const float* __restrict__ p0, float* __restrict__ fe, float* __restrict__ fn,
    float* __restrict__ fw, float* __restrict__ fs, const StepParams& c,
    float* __restrict__ partials, float* sh) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int i = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int nx = c.nx2 - 2, ny = c.ny2 - 2, ny2 = c.ny2;
  float au = 0.0f, av = 0.0f, apr = 0.0f;
  if (i <= nx && j <= ny) {
    const int idx = i * ny2 + j, q = (i - 1) * ny + (j - 1);
    const float pc = p[idx];
    const float pe = p[idx + ny2], pw = p[idx - ny2];
    const float pn = p[idx + 1], ps = p[idx - 1];
    const float un = u[idx] - (c.c_dt_rho * (pe - pw)) / c.two_dx;
    const float vn = v[idx] - (c.c_dt_rho * (pn - ps)) / c.two_dy;
    u[idx] = un;
    v[idx] = vn;
    const float du = un - u0[idx], dv = vn - v0[idx], dp = pc - p0[idx];
    au = du * du;
    av = dv * dv;
    apr = dp * dp;
    fe[q] = fe[q] - ((c.c_dt_rho * (pe - pc)) * c.dy) / c.dx;
    fn[q] = fn[q] - ((c.c_dt_rho * (pn - pc)) * c.dx) / c.dy;
    fw[q] = fw[q] - ((c.c_dt_rho * (pw - pc)) * c.dy) / c.dx;
    fs[q] = fs[q] - ((c.c_dt_rho * (ps - pc)) * c.dx) / c.dy;
  }
  const int nb = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
  const float su = srcfd_block_sum(au, sh);
  const float sv = srcfd_block_sum(av, sh);
  const float sp = srcfd_block_sum(apr, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[b] = su;
    partials[nb + b] = sv;
    partials[2 * nb + b] = sp;
  }
}

__global__ void __launch_bounds__(SRCFD_THREADS)
step_project_kernel(float* __restrict__ u, float* __restrict__ v,
                    const float* __restrict__ p, const float* __restrict__ u0,
                    const float* __restrict__ v0, const float* __restrict__ p0,
                    float* __restrict__ fe, float* __restrict__ fn,
                    float* __restrict__ fw, float* __restrict__ fs, StepParams c,
                    float* __restrict__ partials) {
  __shared__ float sh[SRCFD_THREADS];
  project_cells(u, v, p, u0, v0, p0, fe, fn, fw, fs, c, partials, sh);
}

// res[q] = sum of partials[q * n .. q * n + n), q = 0..2, in a fixed order
__global__ void __launch_bounds__(SRCFD_THREADS)
step_sums_kernel(const float* __restrict__ partials, int n, float* __restrict__ res) {
  __shared__ float sh[SRCFD_THREADS];
  for (int q = 0; q < 3; ++q) {
    float acc = 0.0f;
    for (int k = threadIdx.x; k < n; k += blockDim.x) acc += partials[q * n + k];
    const float s = srcfd_block_sum(acc, sh);
    if (threadIdx.x == 0) res[q] = s;
  }
}

// ---- design (b)'s folded stages ------------------------------------------

// relaxation and its boundary fill in one launch, out of place: dst = src
// relaxed towards f0 (f0 + alpha (src - f0) on the interior where `relax`,
// else src) with the ring filled from the relaxed inside cells, each
// recomputed by the ghost's thread from the same operands (so no cell is
// read after another thread writes it), and the corners copied. Bit-equal
// to step_relax_kernel then step_bc_kernel in place. Launch on
// srcfd_grid(nx2, ny2).
__device__ __forceinline__ float relaxed(const float* __restrict__ src,
                                         const float* __restrict__ f0, int idx,
                                         float alpha, int relax) {
  return relax ? f0[idx] + alpha * (src[idx] - f0[idx]) : src[idx];
}

__global__ void __launch_bounds__(SRCFD_THREADS)
step_relax_bc_kernel(const float* __restrict__ src, const float* __restrict__ f0,
                     float* __restrict__ dst, float alpha, int relax, int var,
                     StepParams c, const float* __restrict__ u_in,
                     const float* __restrict__ below) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = c.nx2 - 2, ny = c.ny2 - 2, ny2 = c.ny2;
  if (i > nx + 1 || j > ny + 1) return;
  const int idx = i * ny2 + j;
  const bool row_in = i >= 1 && i <= nx, col_in = j >= 1 && j <= ny;
  if (row_in && col_in) {
    dst[idx] = relaxed(src, f0, idx, alpha, relax);
    return;
  }
  int side, inside;
  if (i == 0 && col_in) {
    side = 0;
    inside = ny2 + j;
  } else if (i == nx + 1 && col_in) {
    side = 1;
    inside = nx * ny2 + j;
  } else if (j == ny + 1 && row_in) {
    side = 2;
    inside = i * ny2 + ny;
  } else if (j == 0 && row_in) {
    side = 3;
    inside = i * ny2 + 1;
  } else {  // a corner
    dst[idx] = src[idx];
    return;
  }
  dst[idx] = bc_value(relaxed(src, f0, inside, alpha, relax), side, j, var, c, u_in,
                      below);
}

// projection, the three residual sums and the ring fills of u and v in one
// launch: step_project_kernel's blocks, then the last block to finish (a
// __threadfence() and an atomicAdd ticket, reset for the next launch) sums
// the partials in step_sums_kernel's order into res and fills the rings of
// u and v (step_bc_kernel's cells, the inside cells read through L2). No
// block waits on another. Bit-equal to step_project_kernel,
// step_sums_kernel and two step_bc_kernel launches.
__global__ void __launch_bounds__(SRCFD_THREADS)
step_project_bc_kernel(float* __restrict__ u, float* __restrict__ v,
                       const float* __restrict__ p, const float* __restrict__ u0,
                       const float* __restrict__ v0, const float* __restrict__ p0,
                       float* __restrict__ fe, float* __restrict__ fn,
                       float* __restrict__ fw, float* __restrict__ fs, StepParams c,
                       float* __restrict__ partials, unsigned* __restrict__ ticket,
                       float* __restrict__ res, const float* __restrict__ u_in,
                       const float* __restrict__ below) {
  __shared__ float sh[SRCFD_THREADS];
  __shared__ int s_last;
  project_cells(u, v, p, u0, v0, p0, fe, fn, fw, fs, c, partials, sh);
  const int t = threadIdx.x + threadIdx.y * blockDim.x;
  const int nb = gridDim.x * gridDim.y;
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == (unsigned)nb - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = 0; q < 3; ++q) {
    float acc = 0.0f;
    for (int k = t; k < nb; k += SRCFD_THREADS) acc += __ldcg(partials + q * nb + k);
    const float s = srcfd_block_sum(acc, sh);
    if (t == 0) res[q] = s;
  }
  const int n = ring_cells(c);
  for (int k = t; k < n; k += SRCFD_THREADS) {
    bc_cell<true>(u, k, 0, c, u_in, below);
    bc_cell<true>(v, k, 1, c, u_in, below);
  }
  if (t == 0) *ticket = 0u;
}

static size_t small_smem_bytes(int nx2, int ny2) {
  return (12 * (size_t)nx2 * ny2 + 2 * (size_t)ny2) * sizeof(float);
}

// dynamic shared memory a block may take on sm_90 (227 KB), less the
// kernel's static reduction scratch and a margin
static const size_t kSmallSmemMax = 232448 - 2 * SRCFD_THREADS * sizeof(float);

extern "C" {

// 1 when design (a) takes a padded (nx2, ny2) grid
int srcfd_step_small_fits(int nx2, int ny2) {
  return small_smem_bytes(nx2, ny2) <= kSmallSmemMax;
}

// allows the design (a) kernel the most dynamic shared memory a grid
// that fits takes; called once per process, before any launch
int srcfd_step_small_init() {
  return (int)cudaFuncSetAttribute(step_small_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmallSmemMax);
}

// design (a): one block for each of the n_cases entries of `cases`
// (indices into the stacked arrays), or with cases null one block on case
// 0 of unstacked arrays (n_cases must be 1); no launch for n_cases = 0
int srcfd_step_small_batched(const float* u, const float* v, const float* p,
                             const float* fe, const float* fn, const float* fw,
                             const float* fs, const float* u_in, const float* below,
                             const float* nu, const StepParams* c, float* u_o,
                             float* v_o, float* p_o, float* fe_o, float* fn_o,
                             float* fw_o, float* fs_o, float* res, int* counts,
                             const int* cases, int n_cases, void* stream) {
  const size_t smem = small_smem_bytes(c->nx2, c->ny2);
  if (smem > kSmallSmemMax || n_cases < 0 || (cases == nullptr && n_cases != 1))
    return (int)cudaErrorInvalidValue;
  if (n_cases == 0) return 0;
  step_small_kernel<<<n_cases, SRCFD_THREADS, smem, (cudaStream_t)stream>>>(
      u, v, p, fe, fn, fw, fs, u_in, below, nu, *c, u_o, v_o, p_o, fe_o, fn_o,
      fw_o, fs_o, res, counts, cases);
  return (int)cudaGetLastError();
}

// number of partial sums one momentum half-sweep writes
int srcfd_step_mom_partials(int nx2, int ny2) {
  const dim3 g = srcfd_grid(nx2, ny2);
  return (int)(g.x * g.y);
}

// number of partial sums (per quantity) the projection writes
int srcfd_step_proj_partials(int nx2, int ny2) {
  const dim3 g = srcfd_grid(nx2 - 2, ny2 - 2);
  return (int)(g.x * g.y);
}

int srcfd_step_mom_half(const float* src, float* dst, const float* f0,
                        const float* fe, const float* fn, const float* fw,
                        const float* fs, const float* nu, const StepParams* c,
                        int color, float* partials, void* stream) {
  srcfd_mom_half_kernel<StepParams, true>
      <<<srcfd_grid(c->nx2, c->ny2), dim3(SRCFD_TX, SRCFD_TY), 0,
         (cudaStream_t)stream>>>(src, dst, f0, fe, fn, fw, fs, nu, *c, color,
                                 partials);
  return (int)cudaGetLastError();
}

int srcfd_step_relax(float* f, const float* f0, int nx2, int ny2, float alpha,
                     void* stream) {
  step_relax_kernel<<<srcfd_grid(nx2 - 2, ny2 - 2), dim3(SRCFD_TX, SRCFD_TY), 0,
                      (cudaStream_t)stream>>>(f, f0, nx2, ny2, alpha);
  return (int)cudaGetLastError();
}

int srcfd_step_bc(float* f, int var, const float* u_in, const float* below,
                  const StepParams* c, void* stream) {
  const int n = 2 * (c->nx2 - 2) + 2 * (c->ny2 - 2);
  step_bc_kernel<<<(n + SRCFD_THREADS - 1) / SRCFD_THREADS, SRCFD_THREADS, 0,
                   (cudaStream_t)stream>>>(f, var, *c, u_in, below);
  return (int)cudaGetLastError();
}

int srcfd_step_fluxes(const float* u, const float* v, float* fe, float* fn,
                      float* fw, float* fs, const StepParams* c, void* stream) {
  step_fluxes_kernel<<<srcfd_grid(c->nx2 - 2, c->ny2 - 2), dim3(SRCFD_TX, SRCFD_TY),
                       0, (cudaStream_t)stream>>>(u, v, fe, fn, fw, fs, *c);
  return (int)cudaGetLastError();
}

int srcfd_step_project(float* u, float* v, const float* p, const float* u0,
                       const float* v0, const float* p0, float* fe, float* fn,
                       float* fw, float* fs, float* partials, const StepParams* c,
                       void* stream) {
  step_project_kernel<<<srcfd_grid(c->nx2 - 2, c->ny2 - 2), dim3(SRCFD_TX, SRCFD_TY),
                        0, (cudaStream_t)stream>>>(u, v, p, u0, v0, p0, fe, fn,
                                                   fw, fs, *c, partials);
  return (int)cudaGetLastError();
}

int srcfd_step_relax_bc(const float* src, const float* f0, float* dst, float alpha,
                        int relax, int var, const float* u_in, const float* below,
                        const StepParams* c, void* stream) {
  step_relax_bc_kernel<<<srcfd_grid(c->nx2, c->ny2), dim3(SRCFD_TX, SRCFD_TY), 0,
                         (cudaStream_t)stream>>>(src, f0, dst, alpha, relax, var, *c,
                                                 u_in, below);
  return (int)cudaGetLastError();
}

int srcfd_step_project_bc(float* u, float* v, const float* p, const float* u0,
                          const float* v0, const float* p0, float* fe, float* fn,
                          float* fw, float* fs, float* partials, unsigned* ticket,
                          float* res, const float* u_in, const float* below,
                          const StepParams* c, void* stream) {
  step_project_bc_kernel<<<srcfd_grid(c->nx2 - 2, c->ny2 - 2),
                           dim3(SRCFD_TX, SRCFD_TY), 0, (cudaStream_t)stream>>>(
      u, v, p, u0, v0, p0, fe, fn, fw, fs, *c, partials, ticket, res, u_in, below);
  return (int)cudaGetLastError();
}

int srcfd_step_sums(const float* partials, int n, float* res, void* stream) {
  step_sums_kernel<<<1, SRCFD_THREADS, 0, (cudaStream_t)stream>>>(partials, n, res);
  return (int)cudaGetLastError();
}

}  // extern "C"
