// Device code shared by the red-black SOR pressure kernels: the residual and
// the update of one cell, and the unified stall policy of their loops.
// rb_sor.cu (the in-place half-sweeps and the single-block loop) and
// shard_rb.cu (the tiled red-black kernel of the tiled and the
// row-decomposed solvers) call the same expressions, so they cannot drift
// apart.
#pragma once

#include <math.h>

#include "common.cuh"

// The update r -> dp of one cell, by `mode`:
// 0: (sor r) * (1 / ap_d), as the standalone TPU kernel (pallas_kernels.py)
//    does;
// 1: (sor r) / ap_d, as the point-iteration pressure stage of the fused step
//    (pallas_step.py:309) and the tiled sweep (pallas_tiled.py:93) do;
// 2: r * inv_ap with inv_ap = sor / ap_d worked out in double and rounded to
//    float32 once, as the per-rank sweep (spmd_pallas.py:73) does.
struct RbCoef {
  float inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d;
  int mode;
};

__device__ __forceinline__ float rb_step(float r, const RbCoef& c) {
  if (c.mode == 1) return (c.sor * r) / c.ap_d;
  if (c.mode == 2) return r * c.inv_ap;
  return c.sor * r * c.inv_ap;
}

// residual b - Fd at index idx of row-major arrays p and b that share the
// row stride ny2
__device__ __forceinline__ float rb_residual(const float* p, const float* b,
                                             int idx, int ny2,
                                             const RbCoef& c) {
  const float f = p[idx];
  const float fd = c.volp * ((p[idx + ny2] - 2.0f * f + p[idx - ny2]) * c.inv_dx2 +
                             (p[idx + 1] - 2.0f * f + p[idx - 1]) * c.inv_dy2);
  return b[idx] - fd;
}

// The unified stall policy (ops/sweeps.py: stall_update / stalled); its
// constants come from the wrapper, which takes them from ops/sweeps.py.
struct StallPolicy {
  float reset_ratio, ratio;
  int patience, min_checks;
};

// One policy step after a check whose rms is `now` (the previous one
// `rms`): a new margin-best resets `stale`, a descending check holds it,
// anything else increments it; `best` propagates NaN as jnp.minimum does.
__device__ __forceinline__ void stall_update(float now, float rms, float& best,
                                             int& stale, const StallPolicy& sp) {
  const bool new_best = now < sp.reset_ratio * best;
  const bool descending = now < sp.ratio * rms;
  stale = new_best ? 0 : (descending ? stale : stale + 1);
  best = (isnan(best) || isnan(now)) ? NAN : fminf(best, now);
}

__device__ __forceinline__ bool stalled(int stale, int checks,
                                        const StallPolicy& sp) {
  return stale >= sp.patience && checks >= sp.min_checks;
}
