"""Sharded multigrid pressure solve of the row-decomposed solver (counterpart of `sr_for_cfd_tpu/parallel/spmd_mg.py`).

The V-cycle of `ops/multigrid.mg_solve_pressure`, decomposed over the ranks:

* the fine levels stay sharded: each rank holds `nxl // n_ranks` interior
  rows. Red-black smoothing takes global parity and communication-avoiding
  halos (one stacked (x, b) exchange per block of k sweeps, 2k halo rows,
  `smooth_ca`), and hands back the post-smoothing residual so that neither
  the restriction nor the cycle's rms exchanges again. The exterior is
  zero: the frozen ghosts are folded into the right-hand side
  (`spmd_step.py`), as on the single-device path. With `use_pallas` the
  smoother is the per-rank red-black sweep kernel
  (`spmd_kernels.shard_rb_sweep`, TPU kernel row 9);
* the row restriction and prolongation between sharded levels are each
  rank's slices of the exact global operator matrices of
  `jax.image.resize` (`ops/multigrid._resize_matrix`, float32 weights as
  in the JAX package), applied to the band extended by one halo row; the
  column transfers are the whole matrices. They are plain matrix products,
  as in the JAX package, in true float32 (TF32 must be off);
* from the first level whose transition cannot stay sharded, the
  restricted residual is gathered and the rest of the cycle runs
  replicated on every rank, on the single-device V-cycle of
  `ops/multigrid.py`; each rank keeps its own rows of the correction.
  Bands of unequal heights (`domain.ShardedSolver`'s padded split) keep
  level 0 sharded: each rank smooths its own band (with `use_pallas` on
  the per-rank kernel), every block planned on the narrowest band; the
  level-0 residual is gathered, and its restriction, the coarser levels
  and the prolongation run replicated (`_Ops`), each rank adding its own
  rows of the correction.

The level schedule, smoother, restriction scale, tolerance and stall
policy are `mg_solve_pressure`'s, so the cycles agree with the JAX
package's to the rounding of the sums and products.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.multigrid import (
    MG_MAX_CYCLES,
    MG_SMOOTHER_SOR,
    LevelSetup,
    _Ops,
    _resize_matrix,
    level_setup,
)
from ..ops.sweeps import np_scalar_type, stall_update, stalled
from . import mesh as ring
from .spmd_step import even_bands, rms_of_sum, sweep_blocks

# keep a level sharded only while every rank holds at least this many rows
MIN_SHARD_ROWS = 8


class SpmdMGPlan(NamedTuple):
    """Static per-case plan (numpy operators, every rank's slices)."""

    setup: LevelSetup       # sizes, spacings, volp per level, scales
    n_shard: int            # levels [0, n_shard) are sharded
    rstack: tuple           # per transition (n_ranks, rows_c, rows_f + 2) or None
    pstack: tuple           # per transition (n_ranks, rows_f, rows_c + 2) or None
    rcolT: tuple            # per transition (mf, mc) or None
    pcolT: tuple            # per transition (mc, mf) or None


def _operator(n_in: int, n_out: int, dtype) -> np.ndarray:
    """The resize operator with float32 weights, as the JAX package builds
    it (`pallas_mg._resize_matrix`), in `dtype`."""
    return _resize_matrix(n_in, n_out, np.float32).astype(dtype)


def _row_slices(nf: int, nc: int, n_dev: int, dtype):
    """Per-rank banded slices of the global row operators: rank r's
    restriction block is R[r rows_c:(r+1) rows_c, r rows_f - 1:(r+1) rows_f
    + 1] against its band extended by one halo row (columns outside the
    domain are zero); the prolongation likewise."""
    rows_f, rows_c = nf // n_dev, nc // n_dev
    R = _operator(nf, nc, dtype)     # (nc, nf)
    P = _operator(nc, nf, dtype)     # (nf, nc)

    def band(mat, r0_out, n_out, c0_in, n_in, width):
        blk = np.zeros((n_out, width), dtype)
        lo, hi = max(c0_in, 0), min(c0_in + width, n_in)
        blk[:, lo - c0_in:hi - c0_in] = mat[r0_out:r0_out + n_out, lo:hi]
        return blk

    rstack = np.stack([band(R, r * rows_c, rows_c, r * rows_f - 1, nf, rows_f + 2)
                       for r in range(n_dev)])
    pstack = np.stack([band(P, r * rows_f, rows_f, r * rows_c - 1, nc, rows_c + 2)
                       for r in range(n_dev)])
    return rstack, pstack


def plan_spmd_mg(nx: int, ny: int, dx: float, dy: float, volp: float,
                 n_dev: int, dtype, min_size: int = 8) -> SpmdMGPlan:
    """The level schedule of `mg_solve_pressure`, the longest prefix of it
    that stays sharded, and the transfer operators."""
    setup = level_setup(nx, ny, dx, dy, volp, min_size)
    sizes = setup.sizes
    n_shard = 0
    for lvl in range(len(sizes) - 1):
        nxf, nxc = sizes[lvl][0], sizes[lvl + 1][0]
        ok = (nxf % n_dev == 0 and nxf // n_dev >= MIN_SHARD_ROWS
              # the row transition must halve exactly (the banded slices
              # assume it) or keep the rows (semi-coarsening)
              and (nxc == nxf or (nxf % 2 == 0 and nxc * 2 == nxf
                                  and nxc % n_dev == 0)))
        if not ok:
            break
        n_shard = lvl + 1

    rstack, pstack, rcolT, pcolT = [], [], [], []
    for lvl in range(n_shard):
        (nxf, nyf), (nxc, nyc) = sizes[lvl], sizes[lvl + 1]
        rs, ps = _row_slices(nxf, nxc, n_dev, dtype) if nxc != nxf else (None, None)
        rstack.append(rs)
        pstack.append(ps)
        if nyc != nyf:
            rcolT.append(_operator(nyf, nyc, dtype).T.copy())
            pcolT.append(_operator(nyc, nyf, dtype).T.copy())
        else:
            rcolT.append(None)
            pcolT.append(None)
    return SpmdMGPlan(setup=setup, n_shard=n_shard, rstack=tuple(rstack),
                      pstack=tuple(pstack), rcolT=tuple(rcolT), pcolT=tuple(pcolT))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the sharded V-cycle's transfers are true float32 products; "
            "set torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


def make_spmd_mg_solve(plan: SpmdMGPlan, group=None, *, dtype, device,
                       tol: float, n_pre: int = 4, n_post: int = 4,
                       sor: float = MG_SMOOTHER_SOR,
                       max_cycles: int = MG_MAX_CYCLES,
                       coarsest_sweeps: int = 40, use_pallas: bool = False,
                       bands=None):
    """`solve(x_band, b_band) -> (x_band, cycles)` on (rows, nyl) interior
    bands. `use_pallas` runs the sharded levels' smoothing sweeps on the
    per-rank kernel (one 2kb-row exchange per kb sweeps, the same erosion
    accounting as `smooth_ca`); the transfers and the replicated tail stay
    plain PyTorch, as they are outside any kernel in the JAX package.
    `bands`, every rank's (first row, rows) at level 0, defaults to the
    even split; unequal bands (nx0 does not divide, so the plan shards no
    level) smooth level 0 on the bands and run the rest replicated."""
    n_dev, rank = ring.size_of(group), ring.rank_of(group)
    setup = plan.setup
    sizes, spacings, volp_levels = setup.sizes, setup.spacings, setup.volp_levels
    nx0, ny0 = sizes[0]
    n_cells = nx0 * ny0
    tail = _Ops(setup, dtype, device, n_pre, n_post, sor, coarsest_sweeps)
    split = bands or even_bands(nx0, n_dev)
    r0, rows0 = split[rank]
    heights = [r for _, r in split]
    uneven = len(set(heights)) > 1

    def geometry(lvl, rows_l):
        """(first row, rows of the narrowest band) of this rank's band at a
        level smoothed on the bands: every rank plans the same blocks."""
        return (r0, min(heights)) if lvl == 0 else (rank * rows_l, rows_l)

    def mine(stack):
        return None if stack is None else torch.as_tensor(stack[rank], device=device)

    def whole(mat):
        return None if mat is None else torch.as_tensor(mat, device=device)

    rmat = [mine(s) for s in plan.rstack]
    pmat = [mine(s) for s in plan.pstack]
    rcolT = [whole(m) for m in plan.rcolT]
    pcolT = [whole(m) for m in plan.pcolT]

    def assemble0(x, h=1):
        """Halo extension with a zero exterior at the domain's edges."""
        up, dn = ring.ring_exchange(x[-h:], x[:h], group)
        return torch.cat([up, x, dn], dim=0)

    def lap_rows(ext, lvl):
        """volp-scaled 5-point Laplacian on the rows inside a row-extended
        block; zero column exterior."""
        inv_dx2, inv_dy2 = spacings[lvl]
        c = ext[1:-1]
        zc = c.new_zeros((c.shape[0], 1))
        xp = torch.cat([zc, c, zc], dim=1)
        return volp_levels[lvl] * ((ext[2:] - 2.0 * c + ext[:-2]) * inv_dx2
                                   + (xp[:, 2:] - 2.0 * c + xp[:, :-2]) * inv_dy2)

    def smooth_ca(x, b, lvl, n_sweeps, omega, extra):
        """Red-black smoothing, one stacked (x, b) exchange per block of k
        sweeps with the halo rows' updates recomputed. `extra` asks for
        the post-smoothing residual b - A x as a by-product (halo depth
        2k + extra): on own rows for extra=1 (the cycle's rms), on own
        rows +-1 for extra=2 (the banded restriction's operand). Its
        out-of-domain rows hold values the zero operator columns drop.
        Returns (x_own, residual or None)."""
        inv_dx2, inv_dy2 = spacings[lvl]
        inv_ap = omega / (-volp_levels[lvl] * (2.0 * inv_dx2 + 2.0 * inv_dy2))
        nxl, nyl = sizes[lvl]
        rows_l = x.shape[0]
        first, narrow = geometry(lvl, rows_l)
        blocks = sweep_blocks(n_sweeps, max(1, (narrow - extra) // 2))

        def masks(h):
            nreg = rows_l + 2 * h - 2
            gi = torch.arange(nreg, device=device)[:, None] + first - h + 1
            jj = torch.arange(nyl, device=device)[None, :]
            red = (gi + jj) % 2 == 0
            dom = (gi >= 0) & (gi < nxl)
            return red & dom, ~red & dom

        res = None
        for bi, kb in enumerate(blocks):
            last = bi == len(blocks) - 1
            h = 2 * kb + (extra if last else 0)
            pair = torch.stack([x, b])
            up, dn = ring.ring_exchange(pair[:, -h:], pair[:, :h], group)
            ext2 = torch.cat([up, pair, dn], dim=1)
            xe, br = ext2[0], ext2[1, 1:-1]
            red_r, blk_r = masks(h)
            for _ in range(kb):
                r = br - lap_rows(xe, lvl)
                xe[1:-1] += torch.where(red_r, r * inv_ap, 0.0)
                r = br - lap_rows(xe, lvl)
                xe[1:-1] += torch.where(blk_r, r * inv_ap, 0.0)
            if last and extra:
                r_full = br - lap_rows(xe, lvl)
                o = h - extra
                res = r_full[o:o + rows_l + 2 * (extra - 1)]
            x = xe[h:-h]
        return x, res

    def smooth_kernel(x, b, lvl, n_sweeps, omega):
        """The per-rank kernel with the communication-avoiding block
        schedule: one 2kb-row exchange buys kb sweeps; b's halo travels
        once per call."""
        from .spmd_kernels import extend_b_halo, shard_rb_sweep

        if n_sweeps == 0:
            return x
        inv_dx2, inv_dy2 = spacings[lvl]
        nxl = sizes[lvl][0]
        rows = x.shape[0]
        first, narrow = geometry(lvl, rows)
        blocks = sweep_blocks(n_sweeps, max(1, narrow // 2))
        h_max = 2 * blocks[0]
        b_ext = extend_b_halo(b, group, h=h_max)
        for kb in blocks:
            h = 2 * kb
            zc = x.new_zeros((rows + 2 * h, 1))
            ext = torch.cat([zc, assemble0(x, h=h), zc], dim=1)
            own, _ = shard_rb_sweep(
                ext, b_ext[h_max - h:h_max + rows + h], first, nxg=nxl,
                inv_dx2=inv_dx2, inv_dy2=inv_dy2, volp=volp_levels[lvl],
                sor=omega, h=h, kb=kb)
            x = own[:, 1:-1]
        return x

    def restrict_band(r, lvl, pre_extended=False):
        """`pre_extended`: r is already on own rows +-1 (the smoother's
        residual by-product)."""
        if rmat[lvl] is not None:
            r = _matmul(rmat[lvl], r if pre_extended else assemble0(r))
        if rcolT[lvl] is not None:
            r = _matmul(r, rcolT[lvl])
        return r * setup.scales[lvl]

    def prolong_band(e, lvl):
        """Coarse band at level lvl + 1 -> fine band at level lvl."""
        if pcolT[lvl] is not None:
            e = _matmul(e, pcolT[lvl])
        if pmat[lvl] is not None:
            e = _matmul(pmat[lvl], assemble0(e))
        return e

    def v_band(x, b, lvl, want_rms=False):
        """One sharded level of the V-cycle; below the sharded levels, the
        replicated tail. Without the kernel, the pre-smoother hands back
        its residual row-extended and, with `want_rms` (level 0), the
        post-smoother the own-row residual of the cycle's rms."""
        if lvl == plan.n_shard:
            full = tail.v_cycle(torch.zeros(sizes[lvl], dtype=b.dtype, device=device),
                                ring.all_gather(b, group), lvl)
            rows = sizes[lvl][0] // n_dev
            return full[rank * rows:(rank + 1) * rows]
        if use_pallas:
            x = smooth_kernel(x, b, lvl, n_pre, sor)
            r_c = restrict_band(b - lap_rows(assemble0(x), lvl), lvl)
        else:
            rowwise = rmat[lvl] is not None
            x, r = smooth_ca(x, b, lvl, n_pre, sor, extra=2 if rowwise else 1)
            r_c = restrict_band(r, lvl, pre_extended=rowwise)
        e_c = v_band(torch.zeros_like(r_c), r_c, lvl + 1)
        x = x + prolong_band(e_c, lvl)
        if use_pallas:
            return smooth_kernel(x, b, lvl, n_post, sor)
        x, r_post = smooth_ca(x, b, lvl, n_post, sor, extra=1 if want_rms else 0)
        return (x, r_post) if want_rms else x

    def smooth_band0(x, b, n_sweeps, omega):
        """Level 0's smoothing on this rank's band: (x, its own-row
        residual)."""
        if use_pallas:
            x = smooth_kernel(x, b, 0, n_sweeps, omega)
        else:
            x, _ = smooth_ca(x, b, 0, n_sweeps, omega, extra=0)
        return x, b - lap_rows(assemble0(x), 0)

    def v_gathered(x, b):
        """One V-cycle on unequal bands: level 0 smoothed on the bands, its
        residual gathered, the transfers and the coarser levels replicated.
        Returns (x, the cycle's own-row residual)."""
        if len(sizes) == 1:
            return smooth_band0(x, b, coarsest_sweeps, 1.5)
        x, r = smooth_band0(x, b, n_pre, sor)
        r_c = tail.restrict(ring.all_gather(r, group, rows=heights), 0)
        e_c = tail.v_cycle(torch.zeros_like(r_c), r_c, 1)
        x = x + tail.prolong(e_c, 0)[r0:r0 + rows0]
        return smooth_band0(x, b, n_post, sor)

    def solve(x_band: torch.Tensor, b_band: torch.Tensor):
        def rms_of(r):
            return rms_of_sum(ring.psum(torch.sum(r * r).reshape(1), group),
                              n_cells, dtype)

        def residual(x):
            return b_band - lap_rows(assemble0(x), 0)

        if uneven:
            def cycle(x):
                x, r = v_gathered(x, b_band)
                return x, rms_of(r)
        elif plan.n_shard == 0:
            # too few rows per rank: the whole hierarchy replicated, own
            # rows kept; b is gathered once per solve
            bf = ring.all_gather(b_band, group)

            def cycle(x):
                out = tail.v_cycle(ring.all_gather(x, group), bf, 0)
                x = out[rank * rows0:(rank + 1) * rows0]
                return x, rms_of(residual(x))
        elif use_pallas:
            def cycle(x):
                x = v_band(x, b_band, 0)
                return x, rms_of(residual(x))
        else:
            def cycle(x):
                # the post-smoother's residual is the exit test's
                x, r = v_band(x, b_band, 0, want_rms=True)
                return x, rms_of(r)

        t = np_scalar_type(dtype)
        rms = best = t(np.inf)
        tol_t = t(tol)
        x = x_band
        stale = it = 0
        with ring.inner_loop() as trip:
            while it < max_cycles and best >= tol_t and not stalled(stale, it) and trip():
                x, now = cycle(x)
                stale, best = stall_update(now, rms, best, stale)
                rms = now
                it += 1
        return x, it

    return solve
