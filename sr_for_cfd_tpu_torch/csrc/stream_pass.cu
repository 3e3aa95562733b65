// The streamed V-cycle's two fine-level passes, each in one launch:
//   pass A: n red-black sweeps of x (the first red half out of place, so
//     that every cell's entry residual is taken before any update), the
//     entry residual's per-block sums and their rms, the residual after the
//     sweeps, its [1,3,3,1] stride-2 row restriction times the per-row
//     norms (or the residual times the scale where the level keeps its
//     rows) and the banded column restriction;
//   pass B: x plus the row-prolonged correction, then n sweeps.
//
// Replaces, on the card, the TPU kernels sr_for_cfd_tpu/ops/pallas_stream.py
// :168 (_pass_a_kernel, pallas_call :481) and :332 (_pass_b_kernel,
// pallas_call :521), which stream the fine level through VMEM in row slabs
// with wide halos so that all of a pass's sweeps cost one trip over HBM.
// Their staged forms (stream_mg.cu and mg_vcycle.cu's stages: 11 and 9
// launches at n = 4) stay as the bit-equality reference and serve an n past
// this kernel's halo.
//
// Bound. Pass A must read x and b once and write x and the level-1
// right-hand side once: at 2048^2 (levels 1024^2 below) 54.5 MB, 0.0163 ms
// at 3.35 TB/s; pass B reads x, b and the correction (1024 x 2048) and
// writes x: 58.7 MB, 0.0175 ms (chip_smoke.py: stream_work). Its float32
// work, 13 operations per cell and sweep, is ~3 us at 67 TFLOP/s. The
// staged forms move each array once per half-sweep: ~0.45 GB for pass A.
//
// Design: a row-marching wavefront with the columns in registers.
// - Work split. A warp owns SP_OWN (96) columns of a strip of rows (the
//   plan's `rows`, a multiple of 8) and loads SP_STRIP (128) columns: the
//   owned ones and SP_HALO (16) on each side. Each lane holds 4 adjacent
//   columns, so that in every half-sweep two of its cells have the active
//   colour. Warps are independent tasks; a block is SP_WARPS of them.
// - The wavefront. The warp marches down its rows. At step k it brings row
//   k + 1 into registers, and half-sweep h (h = 0 .. 2n - 1) updates row
//   k - h: each row is loaded once and every half-sweep advances together.
//   Half-sweep h at row r reads only rows r - 1 .. r + 1 after half-sweep
//   h - 1, which the earlier half-sweeps of the same step have finished, and
//   the active cells read only the other colour, so an in-place register
//   window of 2n + 3 rows (pass A; 2n + 2 for pass B) gives the staged
//   form's values. The window shifts by a row a step (4 register moves a
//   row a lane), which keeps the code two steps long: a window indexed by
//   the step (the loop unrolled by the window's length, 12 steps of code at
//   n = 4) measured slower (PERF.md). In step k every half-sweep's
//   active cells are the lane's columns of parity k, so the step loop,
//   unrolled by 2, has no per-cell colour test.
// - The halos. Each half-sweep leaves its outermost column invalid on each
//   side, so SP_HALO = 16 columns hold 2n + 2 (pass A: the sweeps, the
//   residual and the restriction's band) or 2n (pass B): n <= SP_MAX_A = 7
//   and n <= SP_MAX_B = 8. Rows likewise: half-sweep h runs on the owned
//   rows widened by 2n + 1 - h (pass A) or 2n - 1 - h (pass B) on each side,
//   so the raw rows start 2n + 2 (2n) above the first owned row.
// - Occupancy. Four blocks (16 warps) an SM: 128 registers a thread, which
//   pass A holds without spilling up to n = 4 and pass B up to n = 6; past
//   that the bound is three blocks (168 registers).
// - Loads. cp.async prefetches rows SP_PREFETCH ahead into a per-warp ring
//   in shared memory; b stays there for the 2n + 1 steps that read it. A
//   lane reads only what it copied itself.
// - Bit-equal to the staged forms (under -fmad=false). Every cell goes
//   through mg_ops.cuh's expressions in their order. The entry residual's
//   sums: lane x of the staged 32 x 8 block holds the 8 values of column x
//   in the order of srcfd_block_sum's steps 128, 64 and 32 (a 4-row tree in
//   shared memory), and its steps 16 .. 1 are shuffles by 4, 2, 1 and two
//   in-lane adds over the 4 columns a lane holds: the same pairs. The last
//   block to finish (an atomicAdd ticket, reset for the next launch) sums
//   the partials in srcfd_rms_finalize's order. The row restriction adds
//   each residual row into the two coarse rows it feeds in the staged
//   order ((t0 + 3 t1) + 3 t2) + t3; the column restriction runs fmaf over
//   the band from a shared row, as mg_col_transfer does.
// No block waits on another: no grid sync, no cooperative launch, no spin;
// every loop is bounded by the sizes the wrapper passes.

#include "common.cuh"
#include "mg_ops.cuh"

#define SP_WARPS 4                            // warps (tasks) a block
#define SP_THREADS (32 * SP_WARPS)
#define SP_STRIP 128                          // columns a warp loads: 4 a lane
#define SP_HALO 16                            // loaded columns on each side
#define SP_OWN (SP_STRIP - 2 * SP_HALO)       // columns a warp owns
#define SP_PREFETCH 3                         // rows loaded ahead
#define SP_BAND 4                             // column band width pass A takes
#define SP_MAX_A 7                            // pass A: 2n + 2 <= SP_HALO
#define SP_MAX_B 8                            // pass B: 2n <= SP_HALO
#define SP_SMEM_MAX (96 * 1024)               // dynamic shared bytes allowed
#define SP_FULL 0xffffffffu

// the wrapper's plan, one block per pass and level (ops/stream_pass.py:
// Params mirrors this layout; srcfd_stream_pass_params_size lets it check
// the size); the wrapper keeps the partials, ticket and band alive as long
// as the block
struct StreamPassParams {
  float* partials;       // pass A: the entry residual's sums, gy x gx
  unsigned* ticket;      // pass A: 0 between launches
  const float* col_mat;  // pass A: the column restriction band, or null
  const int* col_lo;
  const int* col_hi;
  int pass, n, nf, mf, nc, mc, coarsen_x, coarsen_y;
  int own, halo, warps, rows, n_strips, n_chunks, ring, prefetch, smem, gx, gy;
  float inv_dx2, inv_dy2, volp, inv_ap, norm_in, norm_bd, n_cells;
};

struct SpArgs {
  const float* x;
  float* y;
  const float* b;
  const float* e;
  float* b1;
  float* rms_out;
  float* partials;
  unsigned* ticket;
  const float* col_mat;
  const int* col_lo;
  const int* col_hi;
  int nf, mf, nc, mc, coarsen_x, coarsen_y, rows, n_strips, n_tasks, gx, n_part;
  float inv_dx2, inv_dy2, volp, inv_ap, norm_in, norm_bd, n_cells;
};

// slots of a warp's b ring, and floats of a warp's shared memory: the x
// ring (x, and for pass B the two correction rows), the b ring and, for
// pass A, the entry tree's 4 rows, one restricted row and the column band
// of its coarse columns (SpBand)
__host__ __device__ constexpr int sp_bslots(int pass, int n) {
  return 2 * n + (pass ? 1 : 2) + SP_PREFETCH;
}
__host__ __device__ constexpr int sp_xfloats(int pass) {
  return (SP_PREFETCH + 1) * (pass ? 3 : 1) * SP_STRIP;
}
__host__ __device__ constexpr int sp_warp_floats(int pass, int n) {
  return sp_xfloats(pass) + sp_bslots(pass, n) * SP_STRIP +
         (pass ? 0 : 5 * SP_STRIP + (SP_OWN / 2) * (2 + SP_BAND));
}

// the largest multiple of b not above a
__device__ __forceinline__ int sp_align(int a, int b) {
  return (a >= 0 ? a / b : -((-a + b - 1) / b)) * b;
}

// r mod m for any r (rows above the level are negative), and the slot d
// rows before slot s of a ring of m
__device__ __forceinline__ int sp_mod(int r, int m) {
  const int q = r % m;
  return q < 0 ? q + m : q;
}
__device__ __forceinline__ int sp_back(int s, int d, int m) {
  return s - d < 0 ? s - d + m : s - d;
}

__device__ __forceinline__ float4 sp_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sp_set4(float (&d)[4], float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// the residuals b - A x of the lane's 4 cells of row c (up: row i - 1, dn:
// row i + 1); the neighbours across lanes by shuffles
__device__ __forceinline__ void sp_resid4(const float (&c)[4], const float (&up)[4],
                                          const float (&dn)[4], float4 bv,
                                          const SpArgs& a, float (&r)[4]) {
  const float lft = __shfl_up_sync(SP_FULL, c[3], 1);
  const float rgt = __shfl_down_sync(SP_FULL, c[0], 1);
  r[0] = bv.x - mg_lap5(c[0], dn[0], up[0], c[1], lft, a.inv_dx2, a.inv_dy2, a.volp);
  r[1] = bv.y - mg_lap5(c[1], dn[1], up[1], c[2], c[0], a.inv_dx2, a.inv_dy2, a.volp);
  r[2] = bv.z - mg_lap5(c[2], dn[2], up[2], c[3], c[1], a.inv_dx2, a.inv_dy2, a.volp);
  r[3] = bv.w - mg_lap5(c[3], dn[3], up[3], rgt, c[2], a.inv_dx2, a.inv_dy2, a.volp);
}

// one half-sweep on the lane's cells of parity p of row c, in place (the
// active cells read only the other colour); cells outside the level stay
// 0; with `use_re`, the residuals `re` already taken (the entry's)
__device__ __forceinline__ void sp_half(int p, float (&c)[4], const float (&up)[4],
                                        const float (&dn)[4], float4 bv,
                                        const bool (&in)[4], const SpArgs& a,
                                        const float (&re)[4], bool use_re) {
  if (p == 0) {
    const float lft = __shfl_up_sync(SP_FULL, c[3], 1);
    const float r0 = use_re ? re[0]
                        : bv.x - mg_lap5(c[0], dn[0], up[0], c[1], lft, a.inv_dx2,
                                         a.inv_dy2, a.volp);
    const float r2 = use_re ? re[2]
                        : bv.z - mg_lap5(c[2], dn[2], up[2], c[3], c[1], a.inv_dx2,
                                         a.inv_dy2, a.volp);
    if (in[0]) c[0] = c[0] + r0 * a.inv_ap;
    if (in[2]) c[2] = c[2] + r2 * a.inv_ap;
  } else {
    const float rgt = __shfl_down_sync(SP_FULL, c[0], 1);
    const float r1 = use_re ? re[1]
                        : bv.y - mg_lap5(c[1], dn[1], up[1], c[2], c[0], a.inv_dx2,
                                         a.inv_dy2, a.volp);
    const float r3 = use_re ? re[3]
                        : bv.w - mg_lap5(c[3], dn[3], up[3], rgt, c[2], a.inv_dx2,
                                         a.inv_dy2, a.volp);
    if (in[1]) c[1] = c[1] + r1 * a.inv_ap;
    if (in[3]) c[3] = c[3] + r3 * a.inv_ap;
  }
}

// The entry r^2 of row k (the lane's 4 columns) into the staged block sums:
// srcfd_block_sum's steps 128, 64 and 32 over the block's 8 rows in the
// warp's 4-row tree, then (row 7 of the block, or the level's last row with
// the rows past it as zeros) its steps 16 .. 1 across the 8 lanes of each
// owned 32-column block; lane 4 + 8q writes block q's partial.
__device__ __forceinline__ void sp_entry_sum(const SpArgs& a, float* tree, int lane,
                                             int k, const float (&t)[4], int c0) {
  float v[4] = {t[0], t[1], t[2], t[3]};
  for (int y = k & 7;; ++y) {
    float* s = tree + 4 * lane;
    float c[4];
    bool done = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (y < 4) {
        s[y * SP_STRIP + e] = v[e];
      } else if (y == 4) {
        s[e] = s[e] + v[e];  // a0
      } else if (y == 5) {
        s[SP_STRIP + e] = s[SP_STRIP + e] + v[e];  // a1
      } else if (y == 6) {
        const float a2 = s[2 * SP_STRIP + e] + v[e];
        s[e] = s[e] + a2;  // b0
      } else {
        const float a3 = s[3 * SP_STRIP + e] + v[e];
        const float b1 = s[SP_STRIP + e] + a3;
        c[e] = s[e] + b1;
        done = true;
      }
    }
    if (done) {
#pragma unroll
      for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = c[e] + __shfl_down_sync(SP_FULL, c[e], w);
      }
      const float total = (c[0] + c[2]) + (c[1] + c[3]);
      if ((lane & 7) == 4 && lane < 28) {
        const int bx = c0 / 32 + (lane >> 3);
        if (bx < a.gx) {
          a.partials[(k >> 3) * a.gx + bx] = total;
          __threadfence();
        }
      }
      return;
    }
    if (k != a.nf - 1) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = 0.0f;
  }
}

// the column band of the warp's coarse columns J = c0 / 2 + s, s < SP_OWN
// / 2, loaded once a task: the first column (relative to the strip), the
// width (at most SP_BAND; the plan checks) and the weights
struct SpBand {
  int lo[SP_OWN / 2];
  int cnt[SP_OWN / 2];
  float w[SP_OWN / 2][SP_BAND];
};

__device__ __forceinline__ void sp_load_band(const SpArgs& a, SpBand* band, int lane,
                                             int c0, int cs) {
  for (int s = lane; s < SP_OWN / 2; s += 32) {
    const int J = c0 / 2 + s;
    int lo = 0, cnt = 0;
    if (J < a.mc) {
      lo = a.col_lo[J];
      cnt = a.col_hi[J] - lo;
    }
    band->lo[s] = lo - cs;
    band->cnt[s] = cnt;
#pragma unroll
    for (int q = 0; q < SP_BAND; ++q)
      band->w[s][q] = q < cnt ? a.col_mat[(size_t)(lo + q) * a.mc + J] : 0.0f;
  }
  __syncwarp();
}

// one restricted row I (the lane's 4 columns, before the norm) out: times
// the row's norm, then to b1 directly or through the column restriction
// (mg_col_value's fmaf over the band, in its order)
__device__ __forceinline__ void sp_emit(const SpArgs& a, int I, const float (&v)[4],
                                        float* rowbuf, const SpBand* band, int lane,
                                        int c0, int col, const bool (&own)[4]) {
  const float norm =
      a.coarsen_x && (I == 0 || I == a.nc - 1) ? a.norm_bd : a.norm_in;
  float w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = v[e] * norm;
  if (!a.coarsen_y) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (own[e]) a.b1[(size_t)I * a.mf + col + e] = w[e];
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) rowbuf[4 * lane + e] = w[e];
  __syncwarp();
  for (int s = lane; s < SP_OWN / 2; s += 32) {
    const int J = c0 / 2 + s;
    if (J < a.mc) {
      const int lo = band->lo[s], cnt = band->cnt[s];
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < SP_BAND; ++q)
        if (q < cnt) acc = fmaf(rowbuf[lo + q], band->w[s][q], acc);
      a.b1[(size_t)I * a.mc + J] = acc * 1.0f;
    }
  }
  __syncwarp();
}

// the lane's owned columns of a finished row out
__device__ __forceinline__ void sp_store(float* y, int row, int mf, int col,
                                         const float (&v)[4], const bool (&own)[4]) {
  float* p = y + (size_t)row * mf + col;
  if (own[0]) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  if (own[2]) *reinterpret_cast<float2*>(p + 2) = make_float2(v[2], v[3]);
}

// shift the register window by one row: xr[w] <- xr[w + 1]
template <int W>
__device__ __forceinline__ void sp_shift(float (&xr)[W][4]) {
#pragma unroll
  for (int w = 0; w + 1 < W; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) xr[w][e] = xr[w + 1][e];
}

// Pass A, one warp's task (a strip of columns, a strip of rows)
template <int N>
__device__ __forceinline__ void pass_a_task(const SpArgs& a, int task, int lane,
                                            float* wsm) {
  // the register window at step k: xr[W - 1 - d] is row k + 1 - d
  constexpr int W = 2 * N + 3;
  constexpr int XS = SP_PREFETCH + 1, BS = sp_bslots(0, N);
  float* xring = wsm;
  float* bring = xring + sp_xfloats(0);
  float* tree = bring + BS * SP_STRIP;
  float* rowbuf = tree + 4 * SP_STRIP;
  SpBand* band = reinterpret_cast<SpBand*>(rowbuf + SP_STRIP);
  const int nf = a.nf, mf = a.mf;
  const int strip = task % a.n_strips, chunk = task / a.n_strips;
  const int c0 = strip * SP_OWN, cs = c0 - SP_HALO, col = cs + 4 * lane;
  const int r0 = chunk * a.rows, r1 = min(r0 + a.rows, nf);
  bool in[4], own[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    in[e] = col + e >= 0 && col + e < mf;
    own[e] = in[e] && col + e >= c0 && col + e < c0 + SP_OWN;
  }
  // raw rows loaded; half-sweep h runs on rows from lo_h + h (to the
  // bottom, which the step range bounds); residual rows; steps (k0 even:
  // step k's active cells are the lane's columns of parity k & 1)
  const int lo_raw = max(r0 - 2 - 2 * N, 0), hi_raw = min(r1 + 1 + 2 * N, nf - 1);
  const int lo_h = r0 - 1 - 2 * N;
  const int g_lo = max(r0 - 1, 0), g_hi = min(r1, nf - 1);
  const int kend = g_hi + 2 * N;
  const int k0 = sp_align(r0 - 3 - 2 * N, 2);
  if (a.coarsen_y) sp_load_band(a, band, lane, c0, cs);

  // ring slots: row r's x in slot r mod XS, its b in slot r mod BS
  auto issue = [&](int row) {
    if (row >= lo_raw && row <= hi_raw) {
      float* dx = xring + sp_mod(row, XS) * SP_STRIP + 4 * lane;
      float* db = bring + sp_mod(row, BS) * SP_STRIP + 4 * lane;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool ok = col + 2 * q >= 0 && col + 2 * q < mf;
        const size_t at = ok ? (size_t)row * mf + col + 2 * q : 0;
        srcfd_cp_async8(dx + 2 * q, a.x + at, ok);
        srcfd_cp_async8(db + 2 * q, a.b + at, ok);
      }
    }
    srcfd_cp_async_commit();
  };
  for (int d = 1; d <= SP_PREFETCH; ++d) issue(k0 + d);

  float xr[W][4];
  float raw[4], cur[4], nxt[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    raw[e] = cur[e] = nxt[e] = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) xr[w][e] = 0.0f;
  }

  auto step = [&](int k, int p) {
    const int bk = sp_mod(k, BS);  // the b slot of row k
    // row k + 1 into the window
    sp_shift(xr);
    issue(k + 1 + SP_PREFETCH);
    srcfd_cp_async_wait_n<SP_PREFETCH>();
    if (k + 1 >= lo_raw && k + 1 <= hi_raw) {
      sp_set4(xr[W - 1], sp_ld4(xring + sp_mod(k + 1, XS) * SP_STRIP + 4 * lane));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xr[W - 1][e] = 0.0f;
    }
    // the entry residual of row k, before any update of it
    float re[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool entry = k >= r0 && k < r1;
    if (entry) {
      sp_resid4(xr[W - 2], raw, xr[W - 1], sp_ld4(bring + bk * SP_STRIP + 4 * lane), a,
                re);
      float t[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) t[e] = in[e] ? re[e] * re[e] : 0.0f;
      sp_entry_sum(a, tree, lane, k, t, c0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[e] = xr[W - 2][e];
    // the 2N half-sweeps: half-sweep h on row k - h
#pragma unroll
    for (int h = 0; h < 2 * N; ++h) {
      const int r = k - h;
      if (k >= lo_h + 2 * h && r >= 0 && r < nf)
        sp_half(p, xr[W - 2 - h], xr[W - 3 - h], xr[W - 1 - h],
                sp_ld4(bring + sp_back(bk, h, BS) * SP_STRIP + 4 * lane), in, a, re,
                h == 0 && entry);
    }
    // the residual of row g = k - 2N and its row restriction
    const int g = k - 2 * N;
    if (g >= g_lo && g <= g_hi) {
      float t[4];
      sp_resid4(xr[1], xr[0], xr[2],
                sp_ld4(bring + sp_back(bk, 2 * N, BS) * SP_STRIP + 4 * lane), a, t);
      bool emit = false;
      int I = 0;
      float v[4];
      if (!a.coarsen_x) {
        emit = g >= r0 && g < r1;
        I = g;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = t[e];
      } else if (g & 1) {  // t2 of row (g - 1) / 2, t0 of row (g + 1) / 2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cur[e] = cur[e] + 3.0f * t[e];
          nxt[e] = t[e];
          v[e] = cur[e] + 0.0f;  // the last coarse row's t3 = 0
        }
        I = (g - 1) / 2;
        emit = g == nf - 1 && 2 * I >= r0;
      } else {  // t3 of row g / 2 - 1, t1 of row g / 2
        if (g > 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = cur[e] = cur[e] + t[e];
          I = g / 2 - 1;
          emit = 2 * I >= r0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[e] = nxt[e] + 3.0f * t[e];
      }
      if (emit) sp_emit(a, I, v, rowbuf, band, lane, c0, col, own);
    }
    // row k - 2N + 1 is final
    const int q = k - 2 * N + 1;
    if (q >= r0 && q < r1) sp_store(a.y, q, mf, col, xr[2], own);
  };
  for (int k = k0; k <= kend; k += 2) {
    step(k, 0);
    if (k + 1 <= kend) step(k + 1, 1);
  }
  srcfd_cp_async_wait();
}

// Pass B, one warp's task
template <int N>
__device__ __forceinline__ void pass_b_task(const SpArgs& a, int task, int lane,
                                            float* wsm) {
  // the register window at step k: xr[W - 1 - d] is row k + 1 - d
  constexpr int W = 2 * N + 2;
  constexpr int XS = SP_PREFETCH + 1, BS = sp_bslots(1, N);
  float* xring = wsm;  // per slot: x, then the two correction rows
  float* bring = xring + sp_xfloats(1);
  const int nf = a.nf, mf = a.mf;
  const int strip = task % a.n_strips, chunk = task / a.n_strips;
  const int c0 = strip * SP_OWN, cs = c0 - SP_HALO, col = cs + 4 * lane;
  const int r0 = chunk * a.rows, r1 = min(r0 + a.rows, nf);
  bool in[4], own[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    in[e] = col + e >= 0 && col + e < mf;
    own[e] = in[e] && col + e >= c0 && col + e < c0 + SP_OWN;
  }
  const int lo_raw = max(r0 - 2 * N, 0), hi_raw = min(r1 + 2 * N - 1, nf - 1);
  const int lo_h = r0 - 2 * N + 1;
  const int kend = r1 + 2 * N - 2;
  const int k0 = sp_align(r0 - 2 * N - 1, 2);

  auto issue = [&](int row) {
    if (row >= lo_raw && row <= hi_raw) {
      float* dx = xring + sp_mod(row, XS) * 3 * SP_STRIP + 4 * lane;
      float* db = bring + sp_mod(row, BS) * SP_STRIP + 4 * lane;
      // the correction rows of mg_row_value (MG_ROW_PROLONG_2X or MG_ROW_COPY)
      int e1 = row, e2 = row;
      if (a.coarsen_x) {
        e1 = row >> 1;
        e2 = (row & 1) ? min(e1 + 1, a.nc - 1) : max(e1 - 1, 0);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool ok = col + 2 * q >= 0 && col + 2 * q < mf;
        const size_t c = ok ? (size_t)(col + 2 * q) : 0;
        srcfd_cp_async8(dx + 2 * q, a.x + (ok ? (size_t)row * mf + c : 0), ok);
        srcfd_cp_async8(dx + SP_STRIP + 2 * q, a.e + (ok ? (size_t)e1 * mf + c : 0), ok);
        srcfd_cp_async8(dx + 2 * SP_STRIP + 2 * q, a.e + (ok ? (size_t)e2 * mf + c : 0),
                        ok && a.coarsen_x);
        srcfd_cp_async8(db + 2 * q, a.b + (ok ? (size_t)row * mf + c : 0), ok);
      }
    }
    srcfd_cp_async_commit();
  };
  for (int d = 1; d <= SP_PREFETCH; ++d) issue(k0 + d);

  float xr[W][4];
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) xr[w][e] = 0.0f;

  auto step = [&](int k, int p) {
    const int bk = sp_mod(k, BS);  // the b slot of row k
    // row k + 1 plus its prolonged correction into the window
    sp_shift(xr);
    issue(k + 1 + SP_PREFETCH);
    srcfd_cp_async_wait_n<SP_PREFETCH>();
    if (k + 1 >= lo_raw && k + 1 <= hi_raw) {
      const float* s = xring + sp_mod(k + 1, XS) * 3 * SP_STRIP + 4 * lane;
      float xv[4], ev[4], fv[4];
      sp_set4(xv, sp_ld4(s));
      sp_set4(ev, sp_ld4(s + SP_STRIP));
      sp_set4(fv, sp_ld4(s + 2 * SP_STRIP));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = a.coarsen_x ? 0.75f * ev[e] + 0.25f * fv[e] : ev[e];
        xr[W - 1][e] = xv[e] + v * 1.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xr[W - 1][e] = 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2 * N; ++h) {
      const int r = k - h;
      if (k >= lo_h + 2 * h && r >= 0 && r < nf)
        sp_half(p, xr[W - 2 - h], xr[W - 3 - h], xr[W - 1 - h],
                sp_ld4(bring + sp_back(bk, h, BS) * SP_STRIP + 4 * lane), in, a, zero,
                false);
    }
    const int q = k - 2 * N + 1;
    if (q >= r0 && q < r1) sp_store(a.y, q, mf, col, xr[1], own);
  };
  for (int k = k0; k <= kend; k += 2) {
    step(k, 0);
    if (k + 1 <= kend) step(k + 1, 1);
  }
  srcfd_cp_async_wait();
}

template <int N>
__global__ void __launch_bounds__(SP_THREADS, (N <= 4 ? 4 : 3)) stream_pass_a_kernel(SpArgs a) {
  extern __shared__ float4 sp_smem[];
  __shared__ float sh[2 * SP_THREADS];
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int task = blockIdx.x * SP_WARPS + warp;
  if (task < a.n_tasks)
    pass_a_task<N>(a, task, lane,
                   reinterpret_cast<float*>(sp_smem) + warp * sp_warp_floats(0, N));
  // the last block to finish sums the partials (each writer fenced its own)
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // srcfd_rms_finalize's order: 256 sums, sum v over partials v, v + 256,
  // ..., then srcfd_block_sum's tree; thread t keeps sums t and t + 128
  float lo = 0.0f, hi = 0.0f;
  for (int m = t; m < a.n_part; m += 2 * SP_THREADS) lo += __ldcg(a.partials + m);
  for (int m = t + SP_THREADS; m < a.n_part; m += 2 * SP_THREADS)
    hi += __ldcg(a.partials + m);
  sh[t] = lo;
  sh[t + SP_THREADS] = hi;
  __syncthreads();
  for (int s = SP_THREADS; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  if (t == 0) {
    *a.ticket = 0u;
    a.rms_out[0] = sqrtf(sh[0] / a.n_cells);
  }
}

template <int N>
__global__ void __launch_bounds__(SP_THREADS, (N <= 6 ? 4 : 3)) stream_pass_b_kernel(SpArgs a) {
  extern __shared__ float4 sp_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int task = blockIdx.x * SP_WARPS + warp;
  if (task < a.n_tasks)
    pass_b_task<N>(a, task, lane,
                   reinterpret_cast<float*>(sp_smem) + warp * sp_warp_floats(1, N));
}

typedef void (*SpKernel)(SpArgs);

static SpKernel sp_kernel(int pass, int n) {
  if (pass == 0) {
    switch (n) {
      case 1: return stream_pass_a_kernel<1>;
      case 2: return stream_pass_a_kernel<2>;
      case 3: return stream_pass_a_kernel<3>;
      case 4: return stream_pass_a_kernel<4>;
      case 5: return stream_pass_a_kernel<5>;
      case 6: return stream_pass_a_kernel<6>;
      case 7: return stream_pass_a_kernel<7>;
    }
  } else {
    switch (n) {
      case 1: return stream_pass_b_kernel<1>;
      case 2: return stream_pass_b_kernel<2>;
      case 3: return stream_pass_b_kernel<3>;
      case 4: return stream_pass_b_kernel<4>;
      case 5: return stream_pass_b_kernel<5>;
      case 6: return stream_pass_b_kernel<6>;
      case 7: return stream_pass_b_kernel<7>;
      case 8: return stream_pass_b_kernel<8>;
    }
  }
  return nullptr;
}

static int sp_cdiv(int a, int b) { return (a + b - 1) / b; }

extern "C" {

int srcfd_stream_pass_params_size() { return (int)sizeof(StreamPassParams); }

// allow the dynamic shared memory of every instantiation (before any launch)
int srcfd_stream_pass_init() {
  for (int pass = 0; pass < 2; ++pass)
    for (int n = 1; n <= (pass ? SP_MAX_B : SP_MAX_A); ++n) {
      const cudaError_t err = cudaFuncSetAttribute(
          sp_kernel(pass, n), cudaFuncAttributeMaxDynamicSharedMemorySize, SP_SMEM_MAX);
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// One pass on interior-shaped (nf, mf) levels, x -> y (out of place): pass
// A (p->pass 0) writes y, the level-1 right-hand side b1 (nc x mc) and the
// entry rms to rms_out; pass B (1) writes y = the swept x + the prolonged
// correction e (nc x mf). Refuses a plan that is not this kernel's.
int srcfd_stream_pass(const StreamPassParams* p, const float* x, float* y,
                      const float* b, const float* e, float* b1, float* rms_out,
                      void* stream) {
  const int pass = p->pass, n = p->n;
  const bool shape = (pass == 0 || pass == 1) && n >= 1 &&
                     n <= (pass ? SP_MAX_B : SP_MAX_A) && p->nf >= 2 && p->mf >= 2 &&
                     p->nf % 2 == 0 && p->mf % 2 == 0 && p->own == SP_OWN &&
                     p->halo == SP_HALO && p->warps == SP_WARPS && p->rows > 0 &&
                     p->rows % 8 == 0 && p->n_strips == sp_cdiv(p->mf, SP_OWN) &&
                     p->n_chunks == sp_cdiv(p->nf, p->rows) &&
                     p->ring == sp_bslots(pass, n) && p->prefetch == SP_PREFETCH &&
                     p->smem == 4 * SP_WARPS * sp_warp_floats(pass, n) &&
                     p->smem <= SP_SMEM_MAX && p->gx == sp_cdiv(p->mf, 32) &&
                     p->gy == sp_cdiv(p->nf, 8) &&
                     p->nc == (p->coarsen_x ? p->nf / 2 : p->nf);
  const bool args =
      x != nullptr && y != nullptr && b != nullptr && x != y &&
      (pass == 1 ? e != nullptr
                 : (b1 != nullptr && rms_out != nullptr && p->partials != nullptr &&
                    p->ticket != nullptr &&
                    (p->coarsen_y ? p->col_mat != nullptr && p->col_lo != nullptr &&
                                        p->col_hi != nullptr && 2 * p->mc == p->mf
                                  : p->mc == p->mf)));
  if (!shape || !args) return (int)cudaErrorInvalidValue;
  SpArgs a;
  a.x = x;
  a.y = y;
  a.b = b;
  a.e = e;
  a.b1 = b1;
  a.rms_out = rms_out;
  a.partials = p->partials;
  a.ticket = p->ticket;
  a.col_mat = p->col_mat;
  a.col_lo = p->col_lo;
  a.col_hi = p->col_hi;
  a.nf = p->nf;
  a.mf = p->mf;
  a.nc = p->nc;
  a.mc = p->mc;
  a.coarsen_x = p->coarsen_x;
  a.coarsen_y = p->coarsen_y;
  a.rows = p->rows;
  a.n_strips = p->n_strips;
  a.n_tasks = p->n_strips * p->n_chunks;
  a.gx = p->gx;
  a.n_part = p->gx * p->gy;
  a.inv_dx2 = p->inv_dx2;
  a.inv_dy2 = p->inv_dy2;
  a.volp = p->volp;
  a.inv_ap = p->inv_ap;
  a.norm_in = p->norm_in;
  a.norm_bd = p->norm_bd;
  a.n_cells = p->n_cells;
  sp_kernel(pass, n)<<<sp_cdiv(a.n_tasks, SP_WARPS), SP_THREADS, p->smem,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
