// One whole red-black SOR pressure sweep for volp * Laplacian(p) = b, plus
// the partial sums of its residual rms, in one pass over device memory.
//
// Replaces the TPU kernel sr_for_cfd_tpu/ops/pallas_tiled.py:118
// (tiled_rb_sweep, kernel body _sweep_kernel at :43), which streams row
// slabs through VMEM with a lag-one halo so that a sweep and its rms cost
// one pass over HBM at any grid size. The loop around it
// (tiled_solve_pressure, :198) is ops/tiled_kernels.py.
//
// Bound. A sweep must read f and b and write f: 12 bytes per cell, 50.4 MB
// at 2050^2, 15 us at 3.35 TB/s; its ~16 float32 operations per cell take
// ~1 us at 67 TFLOP/s. So it is bound by bytes. (At 2048^2, f, b and the
// second f buffer, 50.4 MB together, are about the size of the 50 MB L2.)
//
// Design. One block of SRCFD_THREADS threads owns a TILE x TILE tile of
// interior cells. It loads the tile's original f with a 2-cell halo, and b
// over the tile and its 1-cell ring, into shared memory. It computes the red
// update on the tile and its ring, in place in shared memory: a red cell
// reads only black cells and itself, and a ring cell's red value is
// computed from the same originals, by the same expression, as the
// neighbouring tile computes it for its own cell, so the two agree bit for
// bit (the TPU kernel's redundant halo recompute, in both directions).
// After __syncthreads() it computes the black residual and update on its
// own cells, which read red cells of the tile and its ring only, and writes
// both colours of its own cells to f_out. The sweep runs out of place
// (f_in -> f_out), so no block reads a cell that another block writes, and
// the result does not depend on the tile size. Each block writes one
// partial, the sum of its own red r1^2 and black r2^2; rms_finalize_kernel
// (rb_sor.cu, srcfd_rms_finalize) sums them in a fixed order. No atomics,
// no block waits on another.
//
// TILE = 32: a warp covers one 32-float row of the tile (128 contiguous
// bytes per load and store); the halo adds (36^2 - 32^2) / 32^2 = 27% to the
// f reads, mostly served by L2, where the neighbouring tiles read the same
// lines; two 36 x 36 float arrays are 10.4 KB of shared memory, so eight
// blocks of 256 threads fit on an SM.

#include "rb_ops.cuh"

#define TILE 32
#define SW (TILE + 4)  // row stride of the shared tiles: 2 halo cells a side

__global__ void __launch_bounds__(SRCFD_THREADS)
tiled_rb_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                const float* __restrict__ b_g, float* __restrict__ partials,
                int nx2, int ny2, RbCoef c) {
  // s_b has the shape of s_f (only the tile and its ring are loaded), so
  // that rb_residual indexes both with one index and one stride
  __shared__ float s_f[SW * SW];
  __shared__ float s_b[SW * SW];
  __shared__ float sh[SRCFD_THREADS];
  const int t = threadIdx.x;
  // padded coordinates of shared cell (0, 0)
  const int i0 = 1 + blockIdx.y * TILE - 2;
  const int j0 = 1 + blockIdx.x * TILE - 2;

  for (int k = t; k < SW * SW; k += SRCFD_THREADS) {
    const int li = k / SW, lj = k % SW;
    const int gi = i0 + li, gj = j0 + lj;
    const bool in = gi >= 0 && gi < nx2 && gj >= 0 && gj < ny2;
    s_f[k] = in ? f_in[gi * ny2 + gj] : 0.0f;
    const bool ring = li >= 1 && li <= TILE + 2 && lj >= 1 && lj <= TILE + 2;
    s_b[k] = in && ring ? b_g[gi * ny2 + gj] : 0.0f;
  }
  __syncthreads();

  float acc = 0.0f;
  // red half on the tile and its ring: shared rows and columns 1..TILE+2
  constexpr int RW = TILE + 2;
  for (int k = t; k < RW * RW; k += SRCFD_THREADS) {
    const int li = 1 + k / RW, lj = 1 + k % RW;
    const int gi = i0 + li, gj = j0 + lj;
    if (gi < 1 || gi > nx2 - 2 || gj < 1 || gj > ny2 - 2 || ((gi + gj) & 1))
      continue;
    const int idx = li * SW + lj;
    const float r = rb_residual(s_f, s_b, idx, SW, c);
    s_f[idx] = s_f[idx] + rb_step(r, c);
    const bool own = li >= 2 && li <= TILE + 1 && lj >= 2 && lj <= TILE + 1;
    if (own) acc += r * r;
  }
  __syncthreads();

  // black half on the tile's own cells; both colours written out
  for (int k = t; k < TILE * TILE; k += SRCFD_THREADS) {
    const int li = 2 + k / TILE, lj = 2 + k % TILE;
    const int gi = i0 + li, gj = j0 + lj;
    if (gi > nx2 - 2 || gj > ny2 - 2) continue;
    const int idx = li * SW + lj;
    float v = s_f[idx];
    if ((gi + gj) & 1) {
      const float r = rb_residual(s_f, s_b, idx, SW, c);
      v = v + rb_step(r, c);
      acc += r * r;
    }
    f_out[gi * ny2 + gj] = v;
  }

  const float s = srcfd_block_sum(acc, sh);
  if (t == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

static dim3 tiled_rb_grid(int nx2, int ny2) {
  return dim3((ny2 - 2 + TILE - 1) / TILE, (nx2 - 2 + TILE - 1) / TILE);
}

extern "C" {

// number of partial sums one sweep writes
int srcfd_tiled_rb_partials(int nx2, int ny2) {
  const dim3 g = tiled_rb_grid(nx2, ny2);
  return (int)(g.x * g.y);
}

// one sweep f_in -> f_out with (sor r) / ap_d updates; f_out's ghost ring
// is never written (the caller gives it f_in's)
int srcfd_tiled_rb_sweep(const float* f_in, float* f_out, const float* b,
                         float* partials, int nx2, int ny2, float inv_dx2,
                         float inv_dy2, float volp, float sor, float ap_d,
                         void* stream) {
  const RbCoef c{inv_dx2, inv_dy2, volp, sor, 1.0f / ap_d, ap_d, 1};
  tiled_rb_kernel<<<tiled_rb_grid(nx2, ny2), SRCFD_THREADS, 0,
                    (cudaStream_t)stream>>>(f_in, f_out, b, partials, nx2, ny2,
                                            c);
  return (int)cudaGetLastError();
}

}  // extern "C"
