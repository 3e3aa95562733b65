// The fused momentum pass: k whole red-black momentum sweeps and the last
// sweep's residual sum in one launch, from shared memory; with a loop
// state, the loop's exit decided on the card.
//
// Replaces, on the card, the momentum loops of two TPU kernels:
// - sr_for_cfd_tpu/ops/pallas_momentum.py:222 (tiled_solve_momentum;
//   kernel body _sweep_kernel :73, pallas_call :298), which runs
//   k = check_every sweeps per pass in one trip over HBM with a 3k-row
//   halo (2k for UPWIND) and the last sweep's sum of r^2.
//   ops/momentum_kernels.py launches it once per pass (k = 3 on the
//   big-grid path), the old field interior-shaped;
// - the momentum loops of sr_for_cfd_tpu/ops/pallas_step.py:414
//   (pallas_simple_step, make_step_kernel :82), which keeps every field in
//   VMEM. ops/step_kernels.py's design (b) launches it once per check
//   (k = momentum_check_every, 1 on the north star), the old field padded.
//
// Bound. A pass must read the field, the old field and the four fluxes
// once and write the field once: ~28 bytes a cell, 118 MB at 2050^2, 35 us
// at 3.35 TB/s; ~55 (QUICK) or 31 (UPWIND) float32 operations per cell and
// sweep are ~19 us at k = 3, QUICK, at 67 TFLOP/s. So a pass is bound by
// bytes, and the half-sweep form (staged form below) moved them 2k times.
//
// Design. A block of SRCFD_THREADS threads owns an OT x OT output tile of
// the padded field, anchored at padded (0, 0) (OT = 32; the grid is the
// wrapper's plan, ops/mom_pass.py). It loads the field over the tile and a halo of
// H = 2k + quick cells, and the old field and the fluxes over the cells a
// half-sweep may update (depth 2k - 1), into dynamic shared memory by
// cp.async, zero-filled outside the field, and runs the k sweeps there.
// Constraints that decide the design:
// - Out of place inside the tile. QUICK reads same-colour cells two away,
//   so a half-sweep takes every residual of its colour (r / ap into an
//   increment buffer) before any cell of that colour moves; then it adds
//   the increments. That is the staged form's out-of-place half-sweep, and
//   f + r / ap rounds as it does.
// - The halo. A half-sweep's red cells at depth d read red cells at d + 2
//   (QUICK) and black ones at d + 1; black likewise. Sweep s (0-based)
//   updates its red cells on the tile's ring of depth 2(k - 1 - s) + 1 and
//   then its black cells on depth 2(k - 1 - s); so the first red half reads
//   depth 2k + 1 (QUICK) or 2k (UPWIND, whose far neighbour is the cell
//   itself), and the last black half covers the tile exactly. The TPU
//   kernel's 3k-row halo (pallas_momentum.py:check_halo) is a bound the
//   port need not load.
// - Global rules on a local tile. Colour is (i + j) & 1 in global padded
//   coordinates, QUICK's far neighbours are clamped at global i = 1, nx and
//   j = 1, ny, and only interior cells are updated: every cell goes
//   through momentum.cuh's srcfd_mom_residual_at with the staged form's
//   operands in its order, so fields are bit-equal to it. Ghost cells are
//   read and written out unchanged, as the staged form copies them.
// - The residual sum in the staged order. The staged form writes one red
//   and one black partial per 32 x 8 block of srcfd_grid(nx2, ny2) over the
//   padded field, in that block's thread order, and srcfd_rms_finalize
//   (rb_sor.cu) sums all red then all black ones in srcfd_fixed_sum's
//   order. Output tiles are whole 32 x 8 blocks anchored at padded (0, 0),
//   so the block sums each of its 32 x 8 blocks' last-sweep r^2 of each
//   colour in that thread order (srcfd_block_sums) and writes it at the
//   staged index. The last block to finish (a __threadfence() and an
//   atomicAdd ticket, reset for the next launch) sums the partials in the
//   finalize's order and takes the rms: bit-equal to the staged rms.
//   With a loop state it also runs the loop's step (rb_ops.cuh:
//   loop_state_step: it += k; the test on the rms, or on the best rms for
//   the fused step's loop); every block of a later launch returns at once
//   when `done` is set, so the host enqueues a batch of passes and reads
//   the state once per batch (ops/exit_loop.py).
// - Shared memory. Seven L x L arrays (L = OT + 2H: the field, the
//   increments, the old field, four fluxes) and the OT x OT terms: 63,344
//   bytes at QUICK, k = 3 (three blocks an SM), 40,384 at UPWIND, k = 1. A
//   k whose tile passes MOM_PASS_SMEM_BUDGET (k > 13 QUICK, k > 14 UPWIND)
//   runs on the staged form. 64-cell tiles (186,736 bytes at QUICK, k = 3:
//   one block an SM, 1.17x the cell updates instead of 1.35x) measured
//   slower at both main shapes (PERF.md) and were dropped.
// No block waits on another: no grid sync, no cooperative launch, no spin.
//
// The staged form, the bit-equality reference of the card gates and the
// form of a k past the budget, is momentum.cuh's srcfd_mom_half_kernel:
// one launch per half-sweep over the whole padded field and a finalize
// (tiled_momentum.cu, fused_step.cu).

#include "momentum.cuh"
#include "rb_ops.cuh"

// dynamic shared memory a block may use (ops/mom_pass.py: SMEM_BUDGET);
// with the static sums (MOM_SUMS x SRCFD_THREADS floats) under the 227 KB
// a block can have
#define MOM_PASS_SMEM_BUDGET (216 * 1024)
#define MOM_SUMS 8  // partial sums a block takes at once
#define MOM_TILE 32  // the output tile's side (ops/mom_pass.py: TILE)

// The coefficients srcfd_mom_residual_at reads, QUICK or UPWIND fixed at
// compile time.
template <int Q>
struct MomCoef {
  static constexpr int quick = Q;
  int nx2, ny2;
  float volp, volp_dt, inv_dx2, inv_dy2, ap_d;
};

// the wrapper's plan and constants, one block per loop (ops/mom_pass.py:
// Params mirrors this layout; srcfd_mom_pass_params_size lets it check the
// size); the wrapper keeps the partials, ticket and state alive as long as
// the block
struct MomPassParams {
  float* partials;    // 2 n_part: the red partials, then the black ones
  unsigned* ticket;   // 0 between launches
  TiledState* state;  // the loop state, or null
  int nx2, ny2, quick, k, old_padded;
  int ot, halo, tiles_x, tiles_y, smem, gx, gy;
  int max_iter, on_best, patience, min_checks;
  float volp, volp_dt, inv_dx2, inv_dy2, ap_d;
  float tol, n_cells, reset_ratio, ratio;
  int pad;
};

struct MomArgs {
  const float* src;
  float* dst;
  const float* old;
  const float* fe;
  const float* fn;
  const float* fw;
  const float* fs;
  const float* nu;
  float* partials;
  unsigned* ticket;
  TiledState* st;
  float* rms_out;
  int nx2, ny2, k, old_padded, tiles_x, gx, gy, n_part, max_iter, on_best;
  float volp, volp_dt, inv_dx2, inv_dy2, ap_d, tol, n_cells;
  StallPolicy sp;
};

// one half-sweep's cell m of its colour `half` on the ring of depth d: the
// local (li, lj) and global (i, j); false where the cell is not interior
__device__ __forceinline__ bool half_cell(int m, int wc, int lo, int i0, int j0,
                                          int half, int nx, int ny, int& li,
                                          int& lj, int& i, int& j) {
  const int qr = m / wc;
  li = lo + qr;
  i = i0 + li;
  // colour (i + j) & 1 == half
  lj = lo + 2 * (m - qr * wc) + ((i + j0 + lo + half) & 1);
  j = j0 + lj;
  return i >= 1 && i <= nx && j >= 1 && j <= ny;
}

template <int OT, int Q, int KK>
__global__ void __launch_bounds__(SRCFD_THREADS) mom_pass_kernel(MomArgs a) {
  extern __shared__ float smem[];
  __shared__ float sh[MOM_SUMS * SRCFD_THREADS];
  __shared__ int s_last;
  // the loop has ended (an earlier launch set done): no work, no ticket
  if (a.st != nullptr && *(volatile int*)&a.st->done) return;
  const int t = threadIdx.x;
  const int k = KK ? KK : a.k;
  const int H = 2 * k + Q, L = OT + 2 * H, DM = 2 * k - 1;
  float* s_f = smem;
  float* s_inc = s_f + L * L;
  float* s_old = s_inc + L * L;
  float* s_fe = s_old + L * L;
  float* s_fn = s_fe + L * L;
  float* s_fw = s_fn + L * L;
  float* s_fs = s_fw + L * L;
  float* s_t = s_fs + L * L;  // the last sweep's r^2 on the tile
  const int ta = blockIdx.x / a.tiles_x, tb = blockIdx.x - ta * a.tiles_x;
  const int i0 = ta * OT - H, j0 = tb * OT - H;  // padded (i, j) of local (0, 0)
  const int nx = a.nx2 - 2, ny = a.ny2 - 2;

  // the field over the tile and its halo; the old field and the fluxes
  // over the interior cells a half-sweep may update
  for (int c = t; c < L * L; c += SRCFD_THREADS) {
    const int li = c / L, lj = c - li * L;
    const int i = i0 + li, j = j0 + lj;
    const bool in = i >= 0 && i < a.nx2 && j >= 0 && j < a.ny2;
    srcfd_cp_async4(s_f + c, a.src + (in ? (size_t)i * a.ny2 + j : 0), in);
    if (li >= H - DM && li < H + OT + DM && lj >= H - DM && lj < H + OT + DM) {
      const bool inner = i >= 1 && i <= nx && j >= 1 && j <= ny;
      const size_t q = inner ? (size_t)(i - 1) * ny + (j - 1) : 0;
      const size_t qo = inner && a.old_padded ? (size_t)i * a.ny2 + j : q;
      srcfd_cp_async4(s_old + c, a.old + qo, inner);
      srcfd_cp_async4(s_fe + c, a.fe + q, inner);
      srcfd_cp_async4(s_fn + c, a.fn + q, inner);
      srcfd_cp_async4(s_fw + c, a.fw + q, inner);
      srcfd_cp_async4(s_fs + c, a.fs + q, inner);
    }
  }
  srcfd_cp_async_commit();
  for (int c = t; c < OT * OT; c += SRCFD_THREADS) s_t[c] = 0.0f;
  const MomCoef<Q> cf{a.nx2, a.ny2, a.volp, a.volp_dt, a.inv_dx2, a.inv_dy2, a.ap_d};
  const float nu = a.nu[0];
  srcfd_cp_async_wait();
  __syncthreads();

#pragma unroll
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool last = s == k - 1;
      // the ring depth this half must get right; the region is w x w cells
      // from (lo, lo), w even, so each row holds wc = w / 2 of this colour
      const int d = 2 * (k - 1 - s) + 1 - half;
      const int lo = H - d, w = OT + 2 * d, wc = w / 2;
      int li, lj, i, j;
      for (int m = t; m < w * wc; m += SRCFD_THREADS) {
        if (!half_cell(m, wc, lo, i0, j0, half, nx, ny, li, lj, i, j)) continue;
        const int idx = li * L + lj;
        float ap;
        const float r = srcfd_mom_residual_at(s_f, idx, L, s_old[idx], s_fe[idx],
                                              s_fn[idx], s_fw[idx], s_fs[idx], i, j,
                                              nu, cf, &ap);
        s_inc[idx] = r / ap;
        if (last && li >= H && li < H + OT && lj >= H && lj < H + OT)
          s_t[(li - H) * OT + (lj - H)] = r * r;
      }
      __syncthreads();
      for (int m = t; m < w * wc; m += SRCFD_THREADS) {
        if (!half_cell(m, wc, lo, i0, j0, half, nx, ny, li, lj, i, j)) continue;
        const int idx = li * L + lj;
        s_f[idx] = s_f[idx] + s_inc[idx];
      }
      __syncthreads();
    }
  }

  // the tile out, ghosts as loaded
  for (int c = t; c < OT * OT; c += SRCFD_THREADS) {
    const int ti = c / OT, tj = c - ti * OT;
    const int i = ta * OT + ti, j = tb * OT + tj;
    if (i < a.nx2 && j < a.ny2) a.dst[(size_t)i * a.ny2 + j] = s_f[(H + ti) * L + H + tj];
  }

  // the partials of the tile's 32 x 8 blocks, red and black, each in the
  // staged block's thread order (thread t: cell (t / 32, t % 32))
  constexpr int BX = OT / SRCFD_TX, NB = (OT / SRCFD_TY) * BX;
  const int tx = t % SRCFD_TX, ty = t / SRCFD_TX;
  for (int base = 0; base < 2 * NB; base += MOM_SUMS) {
    float v[MOM_SUMS];
#pragma unroll
    for (int u = 0; u < MOM_SUMS; ++u) {
      const int b = (base + u) >> 1, col = (base + u) & 1;
      const int ti = (b / BX) * SRCFD_TY + ty, tj = (b % BX) * SRCFD_TX + tx;
      v[u] = ((ta * OT + ti + tb * OT + tj) & 1) == col ? s_t[ti * OT + tj] : 0.0f;
    }
    srcfd_block_sums<MOM_SUMS>(v, sh);
    if (t == 0) {
#pragma unroll
      for (int u = 0; u < MOM_SUMS; ++u) {
        const int b = (base + u) >> 1, col = (base + u) & 1;
        const int by = ta * (OT / SRCFD_TY) + b / BX, bx = tb * BX + b % BX;
        if (by < a.gy && bx < a.gx) a.partials[col * a.n_part + by * a.gx + bx] = v[u];
      }
    }
  }

  // the last block to finish sums the partials: thread 0 wrote this
  // block's partials, fences them and takes the ticket
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // srcfd_rms_finalize's order over the 2 n_part partials
  float acc = 0.0f;
  for (int m = t; m < 2 * a.n_part; m += SRCFD_THREADS) acc += __ldcg(a.partials + m);
  const float total = srcfd_block_sum(acc, sh);
  if (t != 0) return;
  *a.ticket = 0u;
  const float now = sqrtf(total / a.n_cells);
  if (a.rms_out != nullptr) a.rms_out[0] = now;
  if (a.st != nullptr)
    loop_state_step(a.st, now, a.tol, a.max_iter, a.k, a.on_best, a.sp);
}

typedef void (*MomKernel)(MomArgs);

// the instantiations: QUICK or UPWIND, k = 1 (the north star) and 3 (the
// big grid) as a template constant, any other k at run time (0)
template <int Q>
static MomKernel mom_kernel(int k) {
  switch (k) {
    case 1: return mom_pass_kernel<MOM_TILE, Q, 1>;
    case 3: return mom_pass_kernel<MOM_TILE, Q, 3>;
    default: return mom_pass_kernel<MOM_TILE, Q, 0>;
  }
}

static MomKernel mom_kernel(int quick, int k) {
  return quick ? mom_kernel<1>(k) : mom_kernel<0>(k);
}

static int cdiv(int a, int b) { return (a + b - 1) / b; }

extern "C" {

int srcfd_mom_pass_params_size() { return (int)sizeof(MomPassParams); }

// allow the dynamic shared memory of every instantiation (before any launch)
int srcfd_mom_pass_init() {
  const int ks[] = {0, 1, 3};
  for (int quick = 0; quick < 2; ++quick)
    for (int k : ks) {
      const cudaError_t err = cudaFuncSetAttribute(
          mom_kernel(quick, k), cudaFuncAttributeMaxDynamicSharedMemorySize,
          MOM_PASS_SMEM_BUDGET);
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// one pass: p->k sweeps of src -> dst (padded (nx2, ny2) fields; dst gets
// every cell), the old field padded or interior-shaped (p->old_padded), the
// interior-shaped fluxes and nu[0]; the rms to rms_out (null: none) and/or
// the loop state p->state. Refuses a plan that is not this kernel's.
int srcfd_mom_pass(const MomPassParams* p, const float* src, float* dst,
                   const float* old, const float* fe, const float* fn,
                   const float* fw, const float* fs, const float* nu,
                   float* rms_out, void* stream) {
  const int L = p->ot + 2 * p->halo;
  const int smem = 4 * (7 * L * L + p->ot * p->ot);
  const bool ok = p->ot == MOM_TILE && p->k >= 1 && p->nx2 >= 3 &&
                  p->ny2 >= 3 && (p->quick == 0 || p->quick == 1) &&
                  p->halo == 2 * p->k + p->quick && smem == p->smem &&
                  smem <= MOM_PASS_SMEM_BUDGET &&
                  p->tiles_x == cdiv(p->ny2, p->ot) &&
                  p->tiles_y == cdiv(p->nx2, p->ot) &&
                  p->gx == cdiv(p->ny2, SRCFD_TX) && p->gy == cdiv(p->nx2, SRCFD_TY);
  if (!ok) return (int)cudaErrorInvalidValue;
  MomArgs a;
  a.src = src;
  a.dst = dst;
  a.old = old;
  a.fe = fe;
  a.fn = fn;
  a.fw = fw;
  a.fs = fs;
  a.nu = nu;
  a.partials = p->partials;
  a.ticket = p->ticket;
  a.st = p->state;
  a.rms_out = rms_out;
  a.nx2 = p->nx2;
  a.ny2 = p->ny2;
  a.k = p->k;
  a.old_padded = p->old_padded;
  a.tiles_x = p->tiles_x;
  a.gx = p->gx;
  a.gy = p->gy;
  a.n_part = p->gx * p->gy;
  a.max_iter = p->max_iter;
  a.on_best = p->on_best;
  a.volp = p->volp;
  a.volp_dt = p->volp_dt;
  a.inv_dx2 = p->inv_dx2;
  a.inv_dy2 = p->inv_dy2;
  a.ap_d = p->ap_d;
  a.tol = p->tol;
  a.n_cells = p->n_cells;
  a.sp = StallPolicy{p->reset_ratio, p->ratio, p->patience, p->min_checks};
  mom_kernel(p->quick, p->k)<<<p->tiles_x * p->tiles_y, SRCFD_THREADS, smem,
                                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
