// Whole red-black pressure sweeps of a row block and the residual sum of
// squares of the last one: the one tiled red-black kernel, shared by the
// tiled solver's whole-grid sweeps and the row-decomposed solver's per-rank
// sweeps.
//
// Replaces two TPU kernels:
// - sr_for_cfd_tpu/parallel/spmd_pallas.py:93 (shard_rb_sweep, kernel body
//   _shard_sweep_kernel at :59), which runs kb full red-black sweeps on a
//   rank's (rows + 2h, W) block in VMEM after one 2kb-row halo exchange.
//   parallel/spmd_kernels.py launches the fused form once per call (kb
//   sweeps and the sum), no host read;
// - sr_for_cfd_tpu/ops/pallas_tiled.py:118 (tiled_rb_sweep, kernel body
//   _sweep_kernel at :43), one sweep and its rms over the whole padded grid.
//   That grid is the block of a one-rank split with a one-row halo (its
//   ghost rows): R = nx + 2, W = ny + 2, h = 1, row0 = 0, nxg = rows = nx,
//   where no valid cell lies on the block's first or last row.
//   ops/tiled_kernels.py launches the fused form once per sweep, with the
//   loop's exit state on the card, in batches read once each.
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
// plain version (shard_rb_sweep_plain, a transcription of the TPU kernel);
// the one-sweep form's ping-pong buffers only need the block's edges, which
// the caller copies in with the block. On a whole padded grid (row 5) and
// on a boundary or only rank, the edge rows are invalid anyway.
//
// Bound. A row 9 call must read ext and b once and write the own rows: at a
// 2048-wide band of 256 rows with h = 16 (kb = 8), 2 x 288 x 2050 x 4 +
// 256 x 2050 x 4 bytes = 6.8 MB, 2 us at 3.35 TB/s; its kb sweeps do ~14
// float32 operations per valid cell and sweep, ~66 MFLOP at kb = 8, 1 us at
// 67 TFLOP/s. A tiled sweep must read f and b and write f: 12 bytes per
// cell, 50.4 MB at 2050^2, 15 us. Both are bound by bytes.
//
// Two forms of the kernel live here.
//
// The fused form (shard_rb_fused_kernel, srcfd_shard_rb_fused), which both
// solvers launch: kb sweeps and the residual sum in one launch (temporal
// tiling). A block owns an OT x OT output tile of the block's inner cells
// (OT = 32 or 64; tiles anchored at inner cell (1, 1), so that each is whole
// 32 x 32 sum tiles). It loads the tile's f with a 2kb-cell halo, and b over
// the tile and its (2kb - 1)-cell ring, into dynamic shared memory by
// cp.async (zero-filled outside the block), and runs the kb sweeps there:
// sweep s updates its red cells on the tile's ring of depth
// 2(kb - 1 - s) + 1, then, after __syncthreads(), its black cells on depth
// 2(kb - 1 - s), so the exact region shrinks by two cells a sweep and the
// last black half covers the tile. Every cell is computed by rb_residual /
// rb_step from the same originals as in the one-sweep-per-launch form, so
// the own rows are bit-equal to it. The block writes only the own-row cells
// of its tile, out of place (ext (R, W) -> out (rows, W)), and copies
// columns 0 and W - 1 of the own rows from ext. The last sweep's terms
// (r1^2 on own red cells, r2^2 on own black cells) go to a shared tile; per
// 32 x 32 sum tile thread t adds cells t, t + 256, t + 512, t + 768, then
// the fixed tree of srcfd_block_sum, and the partial goes to the sum tile's
// index in the inner cells' 32 x 32 grid, as in the one-sweep form. Tiles
// with no own row are not launched; their partials count as 0. The last
// block to finish (a __threadfence() and an atomicAdd ticket; it resets the
// counter for the next launch or graph replay) sums the partials in
// srcfd_fixed_sum's order. No block waits on another: no grid sync, no
// cooperative launch, no spin. With a loop state (the tiled solver) the
// last block also takes the rms, runs the stall policy and sets `done`;
// every block of a later launch returns at once when `done` is set, so the
// host can enqueue a batch of sweeps and read the state once per batch.
// The tile side and the grid (one block a tile) come from the wrapper's
// plan (ops/shard_rb.py:shard_rb_plan); the C entry refuses a plan that is
// not this kernel's or passes SHARD_RB_SMEM_BUDGET. A kb whose tile does
// not fit the budget (kb > 33) runs on the one-sweep form below.
//
// Where the time goes, measured: the sweeps in shared memory, not the
// copies, set the pace. So kb = 1, 2, 4 and 8 are template constants: the
// ring loops are flat over a region's cells of one colour (every lane
// busy), with constant bounds and divisors, unrolled by two. Tried and
// measured slower or no faster: a per-row loop over every other column, a
// lane per column skipping the other colour, red and black cells split
// into two shared arrays, b read from device memory, 512 and 1024 threads
// a block, a fence in every thread before the ticket, and persistent
// blocks that fetch the next tile into a second stage while they compute
// this one (PERF.md has the times).
//
// The one-sweep form (shard_rb_kernel, srcfd_shard_rb_sweep and
// srcfd_tiled_rb_sweep, then srcfd_sum_finalize or rb_sor.cu's
// srcfd_rms_finalize): one launch per whole sweep between two block
// buffers, which reads and writes the block once per sweep. The fused form
// replaced it on both solvers except for a row 9 kb past the fused form's
// budget; it also runs the private staged and host-exit forms that the
// card gates hold the fused form against. One
// block of SRCFD_THREADS threads owns a TILE x TILE tile of the block's
// inner cells (rows 1..R-2, columns 1..W-2). It loads the tile's original
// f with a 2-cell halo, and b over the tile and its 1-cell ring, into
// shared memory. It computes the red update on the tile and its ring in
// place: a red cell reads only black cells and itself, and a ring cell's
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

// ---------------------------------------------------------------------------
// The fused form.

// dynamic shared memory a block of the fused form may use: its tile of f
// and b and the terms tile (ops/shard_rb.py: SMEM_BUDGET); with the static
// sums (at most 4 KB) under the 227 KB a block can have
#define SHARD_RB_SMEM_BUDGET (220 * 1024)
#define SUM_TILE 32  // the partial sums' tiles: TILE, as in the one-sweep form

// the wrapper's plan and constants, one block per call site; the wrapper
// keeps the partials, ticket and state alive as long as the block
// (ops/shard_rb.py: Params mirrors this layout; srcfd_shard_rb_params_size
// lets it check the size)
struct ShardRbParams {
  float* partials;     // n_sum partial sums
  unsigned* ticket;    // 0 between launches
  TiledState* state;   // the loop state (row 5), or null
  int R, W, nxg, h, rows, kb;
  int ot, tiles_x, a0, tiles_y, smem;
  int gx_sum, n_sum, z0, z1;
  int mode;
  float inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d;
  float tol, n_cells, reset_ratio, ratio;
  int max_iter, patience, min_checks, pad;
};

struct FusedArgs {
  const float* f_in;
  float* out;
  const float* b;
  float* partials;
  unsigned* ticket;
  float* ss_out;
  TiledState* st;
  ShardGeom g;
  RbCoef c;
  StallPolicy sp;
  int kb, tiles_x, a0, n_tiles, gx_sum, gy_sum, n_sum, z0, z1, max_iter;
  float tol, n_cells;
};

// tile q of the launch: (tile row, tile column) in OT-sized tiles of the
// inner cells
__device__ __forceinline__ void tile_origin(const FusedArgs& a, int q, int& ta,
                                            int& tb) {
  const int qy = q / a.tiles_x;
  ta = a.a0 + qy;
  tb = q - qy * a.tiles_x;
}

// start the copies of tile q's f (L x L, a 2kb-cell halo) and b (its
// (2kb - 1)-cell ring) into shared memory; one commit group. The loop is
// flat over the L x L cells (a division by L, a constant where kb is)
template <int OT, int KB>
__device__ void load_tile(const FusedArgs& a, float* s_f, int q) {
  const int kb = KB ? KB : a.kb, L = OT + 4 * kb;
  float* s_b = s_f + L * L;
  int ta, tb;
  tile_origin(a, q, ta, tb);
  const int k0 = 1 + ta * OT - 2 * kb, j0 = 1 + tb * OT - 2 * kb;
  const int t = threadIdx.x + threadIdx.y * SRCFD_TX;
  for (int i = t; i < L * L; i += SRCFD_THREADS) {
    const int li = i / L, lj = i - li * L;
    const int k = k0 + li, j = j0 + lj;
    const bool in = k >= 0 && k < a.g.R && j >= 0 && j < a.g.W;
    const size_t at = in ? (size_t)k * a.g.W + j : 0;
    srcfd_cp_async4(s_f + i, a.f_in + at, in);
    if (li >= 1 && li < L - 1 && lj >= 1 && lj < L - 1) srcfd_cp_async4(s_b + i, a.b + at, in);
  }
  srcfd_cp_async_commit();
}

// kb sweeps of tile q in shared memory, the own rows out, the partials
template <int OT, int KB>
__device__ void tile_work(const FusedArgs& a, float* s_f, float* s_t, float* sh,
                          int q, int klo, int khi, int ioff) {
  constexpr int M = OT / SUM_TILE;
  const int kb = KB ? KB : a.kb, e = 2 * kb, L = OT + 4 * kb;
  const float* s_b = s_f + L * L;
  const int tx = threadIdx.x, ty = threadIdx.y, t = tx + SRCFD_TX * ty;
  int ta, tb;
  tile_origin(a, q, ta, tb);
  const int k0 = 1 + ta * OT - e, j0 = 1 + tb * OT - e;
  const int own_lo = a.g.h, own_hi = a.g.rows + a.g.h;

#pragma unroll
  for (int s = 0; s < kb; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool last = s == kb - 1;
      // the ring depth this half must get right: red 2(kb-1-s)+1, black
      // one less; the region is w x w cells from (lo, lo), w even, so
      // each row holds wc = w / 2 cells of this half's colour
      const int d = 2 * (kb - 1 - s) + 1 - half;
      const int lo = e - d, w = OT + 2 * d, wc = w / 2;
      // flat over the region's cells of this colour (constant bounds and
      // divisor where kb is a template constant); two cells a thread in
      // flight (four measured no faster at kb = 1 and slower at kb 4 and 8)
#pragma unroll 2
      for (int i = t; i < w * wc; i += SRCFD_THREADS) {
        const int qr = i / wc;
        const int li = lo + qr, k = k0 + li;
        // red where k + j + ioff is even
        const int lj = lo + 2 * (i - qr * wc) + ((k + j0 + lo + ioff + half) & 1);
        const int j = j0 + lj;
        if (k < klo || k > khi || j < 1 || j > a.g.W - 2) continue;
        const int idx = li * L + lj;
        const float r = rb_residual(s_f, s_b, idx, L, a.c);
        s_f[idx] = s_f[idx] + rb_step(r, a.c);
        if (last && k >= own_lo && k < own_hi && li >= e && li < e + OT && lj >= e &&
            lj < e + OT)
          s_t[(li - e) * OT + (lj - e)] = r * r;
      }
      __syncthreads();
    }
  }

  // the own rows of the tile, and columns 0 and W - 1 from ext
  for (int ti = ty; ti < OT; ti += SRCFD_TY) {
    const int k = k0 + e + ti;
    if (k < own_lo || k >= own_hi) continue;
    float* orow = a.out + (size_t)(k - own_lo) * a.g.W;
    const float* srow = s_f + (e + ti) * L + e;
    for (int tj = tx; tj < OT; tj += SRCFD_TX) {
      const int j = j0 + e + tj;
      if (j <= a.g.W - 2) orow[j] = srow[tj];
    }
    if (tx == 0 && tb == 0) orow[0] = a.f_in[(size_t)k * a.g.W];
    if (tx == 0 && tb == a.tiles_x - 1)
      orow[a.g.W - 1] = a.f_in[(size_t)k * a.g.W + a.g.W - 1];
  }

  // one partial per 32 x 32 sum tile, in the one-sweep form's order
  float v[M * M];
#pragma unroll
  for (int sy = 0; sy < M; ++sy) {
#pragma unroll
    for (int sx = 0; sx < M; ++sx) {
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < SUM_TILE * SUM_TILE / SRCFD_THREADS; ++n)
        acc += s_t[(sy * SUM_TILE + ty + SRCFD_TY * n) * OT + sx * SUM_TILE + tx];
      v[sy * M + sx] = acc;
    }
  }
  srcfd_block_sums<M * M>(v, sh);
  if (tx == 0 && ty == 0) {
#pragma unroll
    for (int sy = 0; sy < M; ++sy) {
#pragma unroll
      for (int sx = 0; sx < M; ++sx) {
        const int SY = ta * M + sy, SX = tb * M + sx;
        if (SY < a.gy_sum && SX < a.gx_sum) a.partials[SY * a.gx_sum + SX] = v[sy * M + sx];
      }
    }
  }
}

template <int OT, int KB>
__global__ void __launch_bounds__(SRCFD_THREADS)
shard_rb_fused_kernel(FusedArgs a) {
  constexpr int M = OT / SUM_TILE;
  extern __shared__ float smem[];
  __shared__ float sh[M * M * SRCFD_THREADS];
  __shared__ int s_last;
  // the loop has ended (an earlier launch set done): no work, no ticket
  if (a.st != nullptr && *(volatile int*)&a.st->done) return;
  const int t = threadIdx.x + threadIdx.y * SRCFD_TX;
  const int kb = KB ? KB : a.kb, L = OT + 4 * kb;
  float* s_t = smem + 2 * L * L;
  // updated rows: valid (global padded row k + ioff in [1, nxg]) and not
  // the block's first or last row
  const int ioff = a.g.row0 - (a.g.h - 1);
  const int klo = max(1, 1 - ioff), khi = min(a.g.R - 2, a.g.nxg - ioff);

  // a grid-stride loop over the tiles; the grid is the tiles, so each block
  // makes one pass. Written as a loop, nvcc's code for the sweeps measured
  // faster at kb 4 and 8 than the same body straight-line (PERF.md)
  for (int q = blockIdx.x; q < a.n_tiles; q += gridDim.x) {
    load_tile<OT, KB>(a, smem, q);
    for (int i = t; i < OT * OT; i += SRCFD_THREADS) s_t[i] = 0.0f;
    srcfd_cp_async_wait();
    __syncthreads();
    tile_work<OT, KB>(a, smem, s_t, sh, q, klo, khi, ioff);
    __syncthreads();
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
  float acc = 0.0f;
  for (int k = t; k < a.n_sum; k += SRCFD_THREADS)
    acc += (k >= a.z0 && k < a.z1) ? __ldcg(a.partials + k) : 0.0f;
  const float total = srcfd_block_sum(acc, sh);
  if (t != 0) return;
  *a.ticket = 0u;
  if (a.ss_out != nullptr) a.ss_out[0] = total;
  // rms as rb_sor.cu's srcfd_rms_finalize, one sweep per check
  if (a.st != nullptr)
    loop_state_step(a.st, sqrtf(total / a.n_cells), a.tol, a.max_iter, 1, 0, a.sp);
}

typedef void (*FusedKernel)(FusedArgs);

// the instantiations: tile 32 or 64; kb 1, 2, 4 and 8 (the main paths'
// blocks) as a template constant, the sweep loops unrolled and their
// divisions by constants, any other kb at run time (0)
template <int OT>
static FusedKernel fused_kernel(int kb) {
  switch (kb) {
    case 1: return shard_rb_fused_kernel<OT, 1>;
    case 2: return shard_rb_fused_kernel<OT, 2>;
    case 4: return shard_rb_fused_kernel<OT, 4>;
    case 8: return shard_rb_fused_kernel<OT, 8>;
    default: return shard_rb_fused_kernel<OT, 0>;
  }
}

static FusedKernel fused_kernel(int ot, int kb) {
  if (ot == 32) return fused_kernel<32>(kb);
  if (ot == 64) return fused_kernel<64>(kb);
  return nullptr;
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

int srcfd_shard_rb_params_size() { return (int)sizeof(ShardRbParams); }

// allow the fused form's dynamic shared memory (before any launch or
// graph capture)
int srcfd_shard_rb_init() {
  const int kbs[] = {0, 1, 2, 4, 8};  // fused_kernel's instantiations
  for (int ot = 32; ot <= 64; ot += 32)
    for (int kb : kbs) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_kernel(ot, kb), cudaFuncAttributeMaxDynamicSharedMemorySize,
          SHARD_RB_SMEM_BUDGET);
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// the fused form: p->kb sweeps of f_in (an (R, W) block whose first own
// row is global interior row row0) -> out (the own rows, (rows, W)), the
// sum to ss_out (row 9; null: none) and/or the loop state p->state.
// Refuses a plan that is not this kernel's or passes the budget.
int srcfd_shard_rb_fused(const ShardRbParams* p, const float* f_in, float* out,
                         const float* b, float* ss_out, int row0, void* stream) {
  const int L = p->ot + 4 * p->kb;
  const int smem = 4 * (2 * L * L + p->ot * p->ot);
  const int n_tiles = p->tiles_x * p->tiles_y;
  const int gy_sum = (p->R - 2 + SUM_TILE - 1) / SUM_TILE;
  const int gx_sum = (p->W - 2 + SUM_TILE - 1) / SUM_TILE;
  const int m = p->ot / SUM_TILE;
  const bool ok = (p->ot == 32 || p->ot == 64) && p->kb >= 1 && p->h >= 1 &&
                  p->rows >= 1 && p->R == p->rows + 2 * p->h && p->W >= 3 &&
                  smem == p->smem && smem <= SHARD_RB_SMEM_BUDGET && n_tiles >= 1 &&
                  p->tiles_x == (p->W - 2 + p->ot - 1) / p->ot &&
                  p->a0 == (p->h - 1) / p->ot &&
                  p->a0 + p->tiles_y - 1 == (p->rows + p->h - 2) / p->ot &&
                  p->gx_sum == gx_sum && p->n_sum == gx_sum * gy_sum &&
                  p->z0 == p->a0 * m * gx_sum &&
                  p->z1 == min((p->a0 + p->tiles_y) * m, gy_sum) * gx_sum;
  if (!ok) return (int)cudaErrorInvalidValue;
  FusedArgs a;
  a.f_in = f_in;
  a.out = out;
  a.b = b;
  a.partials = p->partials;
  a.ticket = p->ticket;
  a.ss_out = ss_out;
  a.st = p->state;
  a.g = ShardGeom{p->R, p->W, row0, p->nxg, p->h, p->rows};
  a.c = RbCoef{p->inv_dx2, p->inv_dy2, p->volp, p->sor, p->inv_ap, p->ap_d, p->mode};
  a.sp = StallPolicy{p->reset_ratio, p->ratio, p->patience, p->min_checks};
  a.kb = p->kb;
  a.tiles_x = p->tiles_x;
  a.a0 = p->a0;
  a.n_tiles = n_tiles;
  a.gx_sum = gx_sum;
  a.gy_sum = gy_sum;
  a.n_sum = p->n_sum;
  a.z0 = p->z0;
  a.z1 = p->z1;
  a.max_iter = p->max_iter;
  a.tol = p->tol;
  a.n_cells = p->n_cells;
  fused_kernel(p->ot, p->kb)<<<n_tiles, dim3(SRCFD_TX, SRCFD_TY), smem,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
