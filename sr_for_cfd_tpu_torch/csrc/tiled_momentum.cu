// Red-black momentum loop for any grid size, one launch per half-sweep: the
// staged form of the big-grid momentum loop. The loop itself runs on the
// fused momentum pass (mom_pass.cu: k sweeps and the residual sum in one
// launch, the exit on the card); this entry runs a k past that pass's
// shared memory and is the reference the card gates hold it against, bit
// for bit.
//
// Replaces the TPU kernel sr_for_cfd_tpu/ops/pallas_momentum.py:222
// (tiled_solve_momentum; kernel body _sweep_kernel :73, pallas_call :298),
// which streams the padded field, the old field and the four face fluxes
// through VMEM in row slabs with a 3k-row halo (2k for UPWIND) and runs
// k = check_every whole sweeps per pass over HBM, plus the last sweep's
// sum of r^2.
//
// Bound. A half-sweep reads the field (its +-1 and +-2 neighbours come from
// cache), the old field and four fluxes and writes the field: ~28 bytes per
// cell, 118 MB at 2048x2048, ~35 us at 3.35 TB/s; its ~60 float32
// operations per updated cell are ~4 us at 67 TFLOP/s. So a half-sweep is
// bound by device memory, and a pass of k sweeps costs 2k of them.
//
// Design. The H100 has no VMEM wall, so there are no slabs: one launch
// covers the whole padded field with one thread per cell. QUICK reads cells
// of the same colour two rows or columns away, so a half-sweep updated in
// place would read cells it has already moved; every half-sweep therefore
// runs out of place (src -> dst, the other colour and the ghosts copied),
// and the wrapper ping-pongs two buffers. The last sweep of a pass writes
// per-block sums of r^2 of the cells it updates (red half, then black
// half), which srcfd_rms_finalize (rb_sor.cu) reduces in a fixed order;
// the host reads that rms once per pass and applies the stall policy.
// The partials count is srcfd_step_mom_partials's (the same grid).
// The half-sweep kernel is momentum.cuh's, shared with fused_step.cu; here
// the old field is interior-shaped. No block waits on another; the host
// loop is bounded by max_iter.

#include "common.cuh"
#include "momentum.cuh"

struct TmParams {
  int nx2, ny2, quick;
  float volp, volp_dt, inv_dx2, inv_dy2, ap_d;
};

extern "C" {

int srcfd_tm_half(const float* src, float* dst, const float* old,
                  const float* fe, const float* fn, const float* fw,
                  const float* fs, const float* nu, int nx2, int ny2,
                  int quick, float volp, float volp_dt, float inv_dx2,
                  float inv_dy2, float ap_d, int color, float* partials,
                  void* stream) {
  const TmParams c{nx2, ny2, quick, volp, volp_dt, inv_dx2, inv_dy2, ap_d};
  srcfd_mom_half_kernel<TmParams, false>
      <<<srcfd_grid(nx2, ny2), dim3(SRCFD_TX, SRCFD_TY), 0,
         (cudaStream_t)stream>>>(src, dst, old, fe, fn, fw, fs, nu, c, color,
                                 partials);
  return (int)cudaGetLastError();
}

}  // extern "C"
