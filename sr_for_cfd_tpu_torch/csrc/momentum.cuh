// The red-black momentum residual, shared by the fused step (fused_step.cu),
// the fused momentum pass (mom_pass.cu) and the half-sweep kernel below,
// which is the staged form of both momentum loops (tiled_momentum.cu,
// fused_step.cu). It follows the TPU kernels' arithmetic operation by
// operation (pallas_step.py make_step_kernel, pallas_momentum.py
// _sweep_kernel): Laplacian times 1/dx^2 and 1/dy^2, QUICK's +-2
// neighbours clamped at the first and last interior lines.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

// r = -(volp/dt (f - f0) + Fc - nu Fd) at padded (i, j), f[idx] being
// that cell in an array of row stride `stride` (the padded field, or a
// tile of it in shared memory), with f0v the old value of the cell and its
// four face fluxes; *ap_out = volp/dt + ap_c - nu ap_d. (i, j) only decide
// where QUICK's far neighbours are clamped. P holds nx2, ny2, quick, volp,
// volp_dt, inv_dx2, inv_dy2 and ap_d.
template <class P>
__device__ __forceinline__ float srcfd_mom_residual_at(
    const float* f, int idx, int stride, float f0v, float fe, float fn,
    float fw, float fs, int i, int j, float nu, const P& c, float* ap_out) {
  const int nx = c.nx2 - 2, ny = c.ny2 - 2;
  const float F = f[idx];
  const float e = f[idx + stride], w = f[idx - stride];
  const float n = f[idx + 1], s = f[idx - 1];
  const bool pe = fe >= 0.0f, pw = fw >= 0.0f, pn = fn >= 0.0f, ps = fs >= 0.0f;
  float ue, uw, un, us, sum_flux;
  if (c.quick) {
    // far neighbours clamped at the first and last interior lines
    const float ee = i == nx ? e : f[idx + 2 * stride];
    const float ww = i == 1 ? w : f[idx - 2 * stride];
    const float nn = j == ny ? n : f[idx + 2];
    const float ss = j == 1 ? s : f[idx - 2];
    ue = pe ? (0.75f * F + 0.375f * e) - 0.125f * w
            : (0.75f * e + 0.375f * F) - 0.125f * ee;
    uw = pw ? (0.75f * F + 0.375f * w) - 0.125f * e
            : (0.75f * w + 0.375f * F) - 0.125f * ww;
    un = pn ? (0.75f * F + 0.375f * n) - 0.125f * s
            : (0.75f * n + 0.375f * F) - 0.125f * nn;
    us = ps ? (0.75f * F + 0.375f * s) - 0.125f * n
            : (0.75f * s + 0.375f * F) - 0.125f * ss;
    sum_flux = (((pe ? 0.75f : 0.375f) * fe + (pw ? 0.75f : 0.375f) * fw) +
                (pn ? 0.75f : 0.375f) * fn) +
               (ps ? 0.75f : 0.375f) * fs;
  } else {
    ue = pe ? F : e;
    uw = pw ? F : w;
    un = pn ? F : n;
    us = ps ? F : s;
    sum_flux = (((pe ? fe : 0.0f) + (pw ? fw : 0.0f)) + (pn ? fn : 0.0f)) +
               (ps ? fs : 0.0f);
  }
  const float fc = ((ue * fe + uw * fw) + un * fn) + us * fs;
  const float ap_c = sum_flux * c.volp;
  const float fd = c.volp * (((e - 2.0f * F) + w) * c.inv_dx2 +
                             ((n - 2.0f * F) + s) * c.inv_dy2);
  *ap_out = (c.volp_dt + ap_c) - nu * c.ap_d;
  return -((c.volp_dt * (F - f0v) + fc) - nu * fd);
}

// The same at padded (i, j) of a padded field f (ny2 contiguous), the
// fluxes at fidx.
template <class P>
__device__ __forceinline__ float srcfd_mom_residual(
    const float* f, float f0v, const float* __restrict__ fe_a,
    const float* __restrict__ fn_a, const float* __restrict__ fw_a,
    const float* __restrict__ fs_a, int i, int j, int fidx, float nu,
    const P& c, float* ap_out) {
  return srcfd_mom_residual_at(f, i * c.ny2 + j, c.ny2, f0v, fe_a[fidx], fn_a[fidx],
                               fw_a[fidx], fs_a[fidx], i, j, nu, c, ap_out);
}

// One red-black half-sweep of colour `color` ((i + j) % 2 in padded
// coordinates), src -> dst over the whole padded field; cells of the other
// colour and the ghosts are copied. QUICK reads same-colour cells two rows
// or columns away, so a half-sweep cannot run in place. The fluxes are
// interior-shaped; the old field is padded (kOldPadded) or interior-shaped.
// With partials, partials[block] = the sum of r^2 over the block's updated
// cells. Launch on srcfd_grid(c.nx2, c.ny2).
template <class P, bool kOldPadded>
__global__ void __launch_bounds__(SRCFD_THREADS)
srcfd_mom_half_kernel(const float* __restrict__ src, float* __restrict__ dst,
                      const float* __restrict__ old, const float* __restrict__ fe,
                      const float* __restrict__ fn, const float* __restrict__ fw,
                      const float* __restrict__ fs,
                      const float* __restrict__ nu_g, P c, int color,
                      float* __restrict__ partials) {
  __shared__ float sh[SRCFD_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = c.nx2 - 2, ny = c.ny2 - 2;
  float r2 = 0.0f;
  if (i < c.nx2 && j < c.ny2) {
    const int idx = i * c.ny2 + j;
    float out = src[idx];
    if (i >= 1 && i <= nx && j >= 1 && j <= ny && ((i + j) & 1) == color) {
      const int fidx = (i - 1) * ny + (j - 1);
      float ap;
      const float r = srcfd_mom_residual(src, old[kOldPadded ? idx : fidx], fe,
                                         fn, fw, fs, i, j, fidx, nu_g[0], c,
                                         &ap);
      out = out + r / ap;
      r2 = r * r;
    }
    dst[idx] = out;
  }
  if (partials != nullptr) {  // uniform over the launch
    const float s = srcfd_block_sum(r2, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}
