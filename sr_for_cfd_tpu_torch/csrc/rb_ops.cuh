// Device code shared by the red-black SOR pressure kernels: the residual and
// the update of one cell, and the unified stall policy of their loops.
// rb_sor.cu (the in-place half-sweeps, the single-block loop and the
// one-warp loop) and shard_rb.cu (the tiled red-black kernel of the tiled
// and the row-decomposed solvers) call the same expressions, so they
// cannot drift apart. The loop state of a device-exit loop and its step
// are shared with mom_pass.cu (the fused momentum pass).
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

template <int MODE>
__device__ __forceinline__ float rb_step_mode(float r, const RbCoef& c) {
  if (MODE == 1) return (c.sor * r) / c.ap_d;
  if (MODE == 2) return r * c.inv_ap;
  return c.sor * r * c.inv_ap;
}

// rb_step_mode by c.mode (a branch a call; the one-warp loop of rb_sor.cu
// takes the mode as a template argument, so that a half-sweep has none)
__device__ __forceinline__ float rb_step(float r, const RbCoef& c) {
  if (c.mode == 1) return rb_step_mode<1>(r, c);
  if (c.mode == 2) return rb_step_mode<2>(r, c);
  return rb_step_mode<0>(r, c);
}

// residual b - Fd of a cell of value f whose neighbours are f_e (i + 1),
// f_w (i - 1), f_n (j + 1) and f_s (j - 1)
__device__ __forceinline__ float rb_residual_v(float f, float f_e, float f_w,
                                               float f_n, float f_s, float b,
                                               const RbCoef& c) {
  const float fd = c.volp * ((f_e - 2.0f * f + f_w) * c.inv_dx2 +
                             (f_n - 2.0f * f + f_s) * c.inv_dy2);
  return b - fd;
}

// rb_residual_v at index idx of row-major arrays p and b that share the
// row stride ny2
__device__ __forceinline__ float rb_residual(const float* p, const float* b,
                                             int idx, int ny2,
                                             const RbCoef& c) {
  return rb_residual_v(p[idx], p[idx + ny2], p[idx - ny2], p[idx + 1],
                       p[idx - 1], b[idx], c);
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

// The state of a loop whose exit is decided on the card (the tiled
// pressure loop, shard_rb.cu; the momentum loops, mom_pass.cu). The host
// reads it as 8 int32, rms and best as float32 bits
// (ops/exit_loop.py: ExitState).
struct TiledState {
  float rms, best;
  int stale, checks, it, done, pad0, pad1;
};

// The last block's step of the loop state after a check whose rms is `now`
// (ops/exit_loop.py: exit_state_step is its plain twin): the stall policy,
// `it` advanced by the sweeps of one launch, then `done` where the host
// loop's condition fails (NaN exits): it < max_iter, the tested value >=
// tol (the rms, or with on_best the best rms, as the fused step's momentum
// loop tests, pallas_step.py:247-252), and no stall. Thread 0 of the last
// block only.
__device__ __forceinline__ void loop_state_step(TiledState* st, float now, float tol,
                                                int max_iter, int per_launch,
                                                int on_best, const StallPolicy& sp) {
  const volatile TiledState* vs = st;
  TiledState s;
  s.rms = vs->rms;
  s.best = vs->best;
  s.stale = vs->stale;
  s.checks = vs->checks;
  s.it = vs->it;
  s.pad0 = s.pad1 = 0;
  stall_update(now, s.rms, s.best, s.stale, sp);
  s.rms = now;
  s.checks += 1;
  s.it += per_launch;
  const float tested = on_best ? s.best : s.rms;
  s.done = !(s.it < max_iter && tested >= tol && !stalled(s.stale, s.checks, sp));
  *st = s;
}
