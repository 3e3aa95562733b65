// One whole red-black pressure sweep of a row block, plus the block partials
// of its residual sum of squares: the one tiled red-black kernel, shared by
// the tiled solver's whole-grid sweeps and the row-decomposed solver's
// per-rank sweeps.
//
// Replaces two TPU kernels:
// - sr_for_cfd_tpu/parallel/spmd_pallas.py:93 (shard_rb_sweep, kernel body
//   _shard_sweep_kernel at :59), which runs kb full red-black sweeps on a
//   rank's (rows + 2h, W) block in VMEM after one 2kb-row halo exchange.
//   parallel/spmd_kernels.py launches this kernel kb times, one whole sweep
//   per launch, between two block-sized buffers, then srcfd_sum_finalize
//   over the last launch's partials: kb + 1 launches per call, no host read;
// - sr_for_cfd_tpu/ops/pallas_tiled.py:118 (tiled_rb_sweep, kernel body
//   _sweep_kernel at :43), one sweep and its rms over the whole padded grid.
//   That grid is the block of a one-rank split with a one-row halo (its
//   ghost rows): R = nx + 2, W = ny + 2, h = 1, row0 = 0, nxg = rows = nx,
//   where no valid cell lies on the block's first or last row.
//   ops/tiled_kernels.py launches it once per sweep, then srcfd_rms_finalize
//   (rb_sor.cu) over the partials.
//
// What a sweep computes (spmd_pallas.py:59-89). Local row k of the block is
// global padded row i = row0 + k - (h - 1); a cell is valid when i lies in
// [1, nxg] and its column j in [1, W - 2]; red is (i + j) even. The update
// is rb_ops.cuh's rb_step by the caller's mode: r * inv_ap with inv_ap =
// sor / ap_d rounded to float32 once (mode 2, row 9), or (sor r) / ap_d
// (mode 1, the tiled sweep). Invalid cells keep their values. The sum is
// r1^2 on own red cells plus r2^2 on own black cells, own rows being k in
// [h, rows + h).
//
// The block's first and last rows (and its first and last columns) are
// never updated: this kernel leaves them as they are, where the TPU kernel
// updates a valid cell there with the row beyond replicated (_lap :47).
// Both are wrong next to the global sweep, by the same depth: after s
// sweeps the rows within 2s of the block's ends may differ from it, and the
// own rows, h >= 2kb rows in, are exact in both (the erosion argument of
// spmd_pallas.py). So the own rows and the sum agree bit for bit with the
// plain version (shard_rb_sweep_plain, a transcription of the TPU kernel),
// and the ping-pong buffers only need the block's edges, which the caller
// copies in with the block. On a whole padded grid (row 5) and on a
// boundary or only rank, the edge rows are invalid anyway.
//
// Bound. A row 9 call must read ext and b once and write the own rows: at a
// 2048-wide band of 256 rows with h = 16 (kb = 8), 2 x 288 x 2050 x 4 +
// 256 x 2050 x 4 bytes = 6.8 MB, 2 us at 3.35 TB/s; its kb sweeps do ~14
// float32 operations per valid cell and sweep, ~66 MFLOP at kb = 8, 1 us at
// 67 TFLOP/s. A tiled sweep must read f and b and write f: 12 bytes per
// cell, 50.4 MB at 2050^2, 15 us. Both are bound by bytes. This design
// reads and writes the block once per sweep (kb passes a call), which is
// the later speed work's target.
//
// Design. One block of SRCFD_THREADS threads owns a TILE x TILE tile of the
// block's inner cells (rows 1..R-2, columns 1..W-2). It loads the tile's
// original f with a 2-cell halo, and b over the tile and its 1-cell ring,
// into shared memory. It computes the red update on the tile and its ring
// in place: a red cell reads only black cells and itself, and a ring cell's
// red value comes from the same originals, by the same expression, as the
// neighbouring tile computes it for its own cell, so both agree bit for bit
// (the TPU kernels' redundant halo recompute). After __syncthreads() it
// computes the black update on its own cells, which reads red cells of the
// tile and its ring only, and writes both colours out of place (f_in ->
// f_out), so no block reads a cell that another block writes. With
// `with_ss` each block stores its own red cells' r1 in shared memory and,
// in the black loop, adds one term per own cell in a fixed order (thread t:
// cells t, t + 256, t + 512, t + 768 of the tile), then srcfd_block_sum;
// shard_rb_sweep_plain sums in exactly this order, so the two agree bit for
// bit. No atomics, no block waits on another.
//
// TILE = 32: a warp covers one 32-float row of the tile; the halo adds
// (36^2 - 32^2) / 32^2 = 27% to the f reads, mostly served by L2, where the
// neighbouring tiles read the same lines; 15.5 KB of shared memory a block.
// Tiling the inner cells, not the whole block, keeps a 2048^2 sweep at
// 64 x 64 tiles (65 x 65 would leave a last wave of one block).

#include "rb_ops.cuh"

#define TILE 32  // parallel/spmd_kernels.py's TILE: the plain sum follows it
#define SW (TILE + 4)  // row stride of the shared tiles: 2 halo cells a side

// the geometry of one sweep
struct ShardGeom {
  int R, W;   // block shape: rows + 2h, W
  int row0;   // the block's first own interior row (global, from 0)
  int nxg;    // global interior rows
  int h;      // halo rows a side
  int rows;   // own rows
};

__global__ void __launch_bounds__(SRCFD_THREADS)
shard_rb_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                const float* __restrict__ b_g, float* __restrict__ partials,
                ShardGeom g, RbCoef c, int with_ss) {
  // s_b has the shape of s_f (only the tile and its ring are loaded), so
  // that rb_residual indexes both with one index and one stride
  __shared__ float s_f[SW * SW];
  __shared__ float s_b[SW * SW];
  __shared__ float s_r[TILE * TILE];  // own red cells' r1, with_ss only
  __shared__ float sh[SRCFD_THREADS];
  const int t = threadIdx.x;
  // block coordinates of shared cell (0, 0)
  const int k0 = 1 + blockIdx.y * TILE - 2;
  const int j0 = 1 + blockIdx.x * TILE - 2;
  // updated cells: rows klo..khi (valid, and not the block's first or last
  // row: global padded row i = k + ioff), columns 1..W-2; red where
  // (k + j + ioff) is even
  const int ioff = g.row0 - (g.h - 1);
  const int klo = max(1, 1 - ioff), khi = min(g.R - 2, g.nxg - ioff);

  for (int q = t; q < SW * SW; q += SRCFD_THREADS) {
    const int li = q / SW, lj = q % SW;
    const int k = k0 + li, j = j0 + lj;
    const bool in = k >= 0 && k < g.R && j >= 0 && j < g.W;
    s_f[q] = in ? f_in[k * g.W + j] : 0.0f;
    const bool ring = li >= 1 && li <= TILE + 2 && lj >= 1 && lj <= TILE + 2;
    s_b[q] = in && ring ? b_g[k * g.W + j] : 0.0f;
  }
  __syncthreads();

  // red half on the tile and its ring: shared rows and columns 1..TILE+2
  constexpr int RW = TILE + 2;
  for (int q = t; q < RW * RW; q += SRCFD_THREADS) {
    const int li = 1 + q / RW, lj = 1 + q % RW;
    const int k = k0 + li, j = j0 + lj;
    if (k < klo || k > khi || j < 1 || j > g.W - 2 || ((k + j + ioff) & 1))
      continue;
    const int idx = li * SW + lj;
    const float r = rb_residual(s_f, s_b, idx, SW, c);
    s_f[idx] = s_f[idx] + rb_step(r, c);
    const bool tile = li >= 2 && li <= TILE + 1 && lj >= 2 && lj <= TILE + 1;
    if (with_ss && tile) s_r[(li - 2) * TILE + (lj - 2)] = r;
  }
  __syncthreads();

  // black half on the tile's own cells; both colours written out
  float acc = 0.0f;
  for (int q = t; q < TILE * TILE; q += SRCFD_THREADS) {
    const int li = 2 + q / TILE, lj = 2 + q % TILE;
    const int k = k0 + li, j = j0 + lj;
    if (k > g.R - 2 || j > g.W - 2) continue;
    const int idx = li * SW + lj;
    float v = s_f[idx];
    float term = 0.0f;
    if (k >= klo && k <= khi) {
      if (((k + j + ioff) & 1) == 0) {
        if (with_ss) term = s_r[q] * s_r[q];
      } else {
        const float r = rb_residual(s_f, s_b, idx, SW, c);
        v = v + rb_step(r, c);
        term = r * r;
      }
    }
    f_out[k * g.W + j] = v;
    if (with_ss && k >= g.h && k < g.rows + g.h) acc += term;
  }

  if (with_ss) {
    const float s = srcfd_block_sum(acc, sh);
    if (t == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// sum of the partials in srcfd_fixed_sum's order, no root: the row 9
// caller all-reduces it over the ranks before the rms
__global__ void __launch_bounds__(SRCFD_THREADS)
sum_finalize_kernel(const float* __restrict__ partials, int n,
                    float* __restrict__ out) {
  __shared__ float sh[SRCFD_THREADS];
  const float s = srcfd_fixed_sum(partials, n, sh);
  if (threadIdx.x == 0) out[0] = s;
}

static dim3 shard_rb_grid(int R, int W) {
  return dim3((W - 2 + TILE - 1) / TILE, (R - 2 + TILE - 1) / TILE);
}

// one sweep f_in -> f_out; f_out's first and last rows and columns are
// never written (the caller gives it f_in's)
static int shard_rb_launch(const float* f_in, float* f_out, const float* b,
                           float* partials, const ShardGeom& g,
                           const RbCoef& c, int with_ss, void* stream) {
  shard_rb_kernel<<<shard_rb_grid(g.R, g.W), SRCFD_THREADS, 0,
                    (cudaStream_t)stream>>>(f_in, f_out, b, partials, g, c,
                                            with_ss);
  return (int)cudaGetLastError();
}

extern "C" {

// number of partial sums one sweep writes
int srcfd_shard_rb_partials(int R, int W) {
  const dim3 g = shard_rb_grid(R, W);
  return (int)(g.x * g.y);
}

// row 9: one sweep f_in -> f_out of a rank's (R, W) block with r * inv_ap
// updates; with_ss: write the partials
int srcfd_shard_rb_sweep(const float* f_in, float* f_out, const float* b,
                         float* partials, int R, int W, int row0, int nxg,
                         int h, int rows, float inv_dx2, float inv_dy2,
                         float volp, float inv_ap, int with_ss, void* stream) {
  const ShardGeom g{R, W, row0, nxg, h, rows};
  const RbCoef c{inv_dx2, inv_dy2, volp, 0.0f, inv_ap, 0.0f, 2};
  return shard_rb_launch(f_in, f_out, b, partials, g, c, with_ss, stream);
}

// row 5: one sweep f_in -> f_out of a padded (nx2, ny2) field, a one-rank
// block with a one-row halo, with (sor r) / ap_d updates and the partials
int srcfd_tiled_rb_sweep(const float* f_in, float* f_out, const float* b,
                         float* partials, int nx2, int ny2, float inv_dx2,
                         float inv_dy2, float volp, float sor, float ap_d,
                         void* stream) {
  const ShardGeom g{nx2, ny2, 0, nx2 - 2, 1, nx2 - 2};
  const RbCoef c{inv_dx2, inv_dy2, volp, sor, 1.0f / ap_d, ap_d, 1};
  return shard_rb_launch(f_in, f_out, b, partials, g, c, 1, stream);
}

int srcfd_sum_finalize(const float* partials, int n, float* out, void* stream) {
  sum_finalize_kernel<<<1, SRCFD_THREADS, 0, (cudaStream_t)stream>>>(partials,
                                                                     n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
