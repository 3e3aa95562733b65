"""Row-decomposed SIMPLE solver over `torch.distributed` (counterpart of `sr_for_cfd_tpu/parallel/spmd_step.py`).

The JAX package runs the whole outer iteration under `shard_map` with
`ppermute` halo exchange; here every rank of a process group runs the same
step on its own rows and the ranks trade rows through `mesh.ring_exchange`:

* each rank owns `rows = nx // n_ranks` interior rows as (rows, ny + 2)
  bands (the y-ghost columns included: the y boundary conditions are
  rank-local);
* the inner solves exchange once per communication-avoiding block of k
  red-black sweeps: an H-row halo buys k sweeps whose halo-row updates are
  recomputed instead of communicated (H = 2k for the 5-point stencil and
  UPWIND, 2k + 1 for QUICK, see `_make_step.ca_sweep_solve`); k is the
  rms check cadence, so sweep counts and exits are the single-device
  loop's. The per-solve constants (old field, face fluxes, the pressure
  right-hand side) travel once per inner solve, stacked. Bands too narrow
  for one QUICK sweep (rows == 2) exchange every half-sweep;
* the domain's x-ghost rows are computed on the boundary ranks from the
  boundary conditions (the BFS inlet on rank 0) and frozen for each inner
  solve, as the reference freezes its ghosts;
* residual sums are `mesh.psum`, the Cauchy drift `mesh.pmax`; the scalar
  carries of the outer loop (rms, counters, detector windows) are host
  values of the working dtype, the same on every rank, as in the
  single-device port (`solver/state.py`).

With `use_pallas` the pressure runs on the per-rank red-black sweep kernel
(`spmd_kernels.shard_rb_sweep`, TPU kernel row 9): one `2kb`-row exchange,
then kb sweeps in kb launches, the block schedule and rms cadence of the
plain blocks. With `pressure_solver='multigrid'` it runs the sharded V-cycle
of `spmd_mg.py`, whose smoother takes the same kernel under `use_pallas`.

One rank per process; on the card, one card per rank and an NCCL group
(`torchrun --nproc-per-node N` on one host), on the CPU a gloo group.
`checkpoint` / `resume_from` write and read the single-device solver's
`.npz` snapshot. `SpmdWorkflowAdapter` puts the solver behind the surface
that the hybrid workflow drives (`workflow/hybrid.py`, `spmd_devices > 1`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import DIRICHLET, QUICK, CaseConfig
from ..ops import extrapolate as rre
from ..ops.bc import BFSInletProfile, apply_bc, apply_bfs_inlet
from ..ops.stencil import (
    FaceFluxes,
    Shifted,
    diffusion,
    face_fluxes,
    flux_signs,
    quick_flux,
    shifts1,
    upwind_flux,
)
from ..ops.sweeps import momentum_diag, np_scalar_type, optimal_sor, stall_update, stalled
from ..solver.state import SolverState, init_state, inlet_profile, torch_dtype, warm_start_state
from ..utils.device import resolve_device
from . import mesh as ring
from .mesh import AXIS


@dataclass
class SpmdState:
    """One rank's share of the solver state: u, v, p and the Cauchy
    references are (rows, ny + 2) bands, the old fields and face fluxes
    (rows, ny); the scalars are host values, the same on every rank."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    u_old: torch.Tensor
    v_old: torch.Tensor
    p_old: torch.Tensor
    ff: FaceFluxes
    rms: np.ndarray
    count: int
    converged: bool
    diverged: bool
    held: int
    plat_best: np.ndarray
    plat_acc: np.ndarray
    plat_n: int
    plat_stale: int
    cau_u: torch.Tensor
    cau_v: torch.Tensor
    cau_count: int

    def replace(self, **kw) -> "SpmdState":
        return dataclasses.replace(self, **kw)


def sweep_blocks(total: int, k_max: int) -> List[int]:
    """Split `total` sweeps into communication-avoiding blocks of at most
    `k_max` sweeps (largest first); one halo exchange per block."""
    out, rem = [], total
    while rem > 0:
        b = min(k_max, rem)
        out.append(b)
        rem -= b
    return out


def rms_of_sum(ss: torch.Tensor, n_cells: int, dtype: torch.dtype):
    """sqrt(ss / n_cells) in numpy scalars of the working dtype, as the
    JAX loops compute it on the device."""
    t = np_scalar_type(dtype)
    return t(np.sqrt(t(ss.item()) / t(n_cells)))


def _ghost_row(row, side_bc, var_k: int, profile: Optional[BFSInletProfile],
               is_left: bool):
    """The domain x-ghost row derived from its adjacent interior row; the
    BFS inlet on the left for u and v."""
    g = (2.0 * side_bc.value - row) if side_bc.type == DIRICHLET else row
    if is_left and profile is not None and var_k in (0, 1):
        if var_k == 1:
            g = -row
        else:
            g = torch.where(profile.below, -row, 2.0 * profile.u_in - row)
    return g


def _apply_bc_y(x_own: torch.Tensor, bc) -> torch.Tensor:
    """Rank-local y-ghost columns (every own row is a global interior row)."""
    bot = (2.0 * bc.bottom.value - x_own[:, 1]
           if bc.bottom.type == DIRICHLET else x_own[:, 1])
    top = (2.0 * bc.top.value - x_own[:, -2]
           if bc.top.type == DIRICHLET else x_own[:, -2])
    out = x_own.clone()
    out[:, 0] = bot
    out[:, -1] = top
    return out


def _make_rre_ops(case: CaseConfig, profile: Optional[BFSInletProfile],
                  n_dev: int, rank: int):
    """Per-rank flatten / inject for decomposed RRE: the local vector is
    this rank's band of the single-device flat state
    (`extrapolate.flatten_state`), the domain x-ghost rows carried in
    per-rank slots that are zero off the boundary ranks, so the sum over
    the ranks of the partial Grams is the whole-vector Gram."""
    nx, ny = case.mesh.nx, case.mesh.ny
    rows = nx // n_dev
    bcs = {0: case.u_bc, 1: case.v_bc, 2: case.p_bc}

    def flatten(s: SpmdState) -> torch.Tensor:
        parts = []
        for x, k in ((s.u, 0), (s.v, 1), (s.p, 2)):
            bc = bcs[k]
            gl = _ghost_row(x[0], bc.left, k, profile, is_left=True).clone()
            gh = _ghost_row(x[-1], bc.right, k, profile, is_left=False).clone()
            # the single-device snapshot has zeros at the corners
            gl[0] = gl[-1] = 0.0
            gh[0] = gh[-1] = 0.0
            parts.append(gl if rank == 0 else torch.zeros_like(gl))
            parts.append(x.reshape(-1))
            parts.append(gh if rank == n_dev - 1 else torch.zeros_like(gh))
        parts += [s.ff.e.reshape(-1), s.ff.n.reshape(-1),
                  s.ff.w.reshape(-1), s.ff.s.reshape(-1)]
        return torch.cat(parts)

    def inject(s: SpmdState, x_star: torch.Tensor) -> SpmdState:
        band_n, row_n, core = rows * (ny + 2), ny + 2, rows * ny
        off, bands = 0, []
        for k in range(3):
            off += row_n  # the ghost-row slot: derived again on demand
            band = x_star[off:off + band_n].reshape(rows, ny + 2)
            off += band_n + row_n
            bands.append(_apply_bc_y(band, bcs[k]))
        u2, v2, p2 = bands
        ffs = []
        for _ in range(4):
            ffs.append(x_star[off:off + core].reshape(rows, ny))
            off += core
        return s.replace(u=u2, v=v2, p=p2, u_old=u2[:, 1:-1],
                         v_old=v2[:, 1:-1], p_old=p2[:, 1:-1], ff=FaceFluxes(*ffs))

    n_flat_local = 3 * (rows + 2) * (ny + 2) + 4 * rows * ny
    return flatten, inject, n_flat_local


def _make_step(case: CaseConfig, profile: Optional[BFSInletProfile], group,
               device: torch.device):
    """The per-rank step `step(s, nu) -> (s, {'u', 'v', 'p'} inner
    counts)`, closed over the case."""
    mcfg, fluid, st = case.mesh, case.fluid, case.settings
    nx, ny = mcfg.nx, mcfg.ny
    n_dev, rank = ring.size_of(group), ring.rank_of(group)
    rows = nx // n_dev
    if rows < 2:
        # the exchange fetches a 2-row halo from the immediate neighbour
        raise ValueError(
            f"nx={nx} over {n_dev} '{AXIS}' devices leaves {rows} interior "
            f"row(s) per rank; the halo exchange needs at least 2 "
            f"(use a coarser mesh axis or a finer grid)"
        )
    dx, dy, volp, dt = mcfg.dx, mcfg.dy, mcfg.volp, st.dt
    rho = fluid.rho
    quick = st.scheme == QUICK
    n_cells = nx * ny
    p_sor = min(st.pressure_sor, optimal_sor(nx, ny))
    use_pallas_p = st.use_pallas
    use_mg_p = st.pressure_solver == "multigrid"
    dtype = torch_dtype(case)
    t = np_scalar_type(dtype)
    if use_mg_p:
        from .spmd_mg import make_spmd_mg_solve, plan_spmd_mg

        mg_plan = plan_spmd_mg(nx, ny, dx, dy, volp, n_dev, np.dtype(st.dtype),
                               min_size=st.mg_min_size)
        mg_solve = make_spmd_mg_solve(
            mg_plan, group, dtype=dtype, device=device, tol=st.inner_tolerance,
            n_pre=st.mg_n_pre, n_post=st.mg_n_post,
            coarsest_sweeps=st.mg_coarsest_sweeps, use_pallas=use_pallas_p,
        )
    alpha = {k: st.relax(k) for k in ("u", "v", "p")}
    bcs = {0: case.u_bc, 1: case.v_bc, 2: case.p_bc}
    first, last = rank == 0, rank == n_dev - 1

    def red_mask():
        ii = torch.arange(rows, device=device)[:, None] + rank * rows + 1
        jj = torch.arange(ny, device=device)[None, :] + 1
        return (ii + jj) % 2 == 0

    red_own = red_mask()

    def ghosts(x_own, var_k: int):
        """(glow, ghigh) domain x-ghost rows (ny + 2,); read only on the
        boundary ranks."""
        bc = bcs[var_k]
        return (_ghost_row(x_own[0], bc.left, var_k, profile, is_left=True),
                _ghost_row(x_own[-1], bc.right, var_k, profile, is_left=False))

    def assemble(x_own, h: int, glow, ghigh):
        """(rows + 2h, ny + 2): h neighbour rows from the ring; the
        boundary ranks repeat the frozen domain ghost row, as
        `stencil.shifts2` clamps the global +-2 reads to it."""
        from_up, from_dn = ring.ring_exchange(x_own[-h:], x_own[:h], group)
        top = glow.expand(h, ny + 2) if first else from_up
        bot = ghigh.expand(h, ny + 2) if last else from_dn
        return torch.cat([top, x_own, bot], dim=0)

    def shifts2_of(ext2):
        mid = ext2[2:-2]
        cp = torch.cat([mid[:, :1], mid, mid[:, -1:]], dim=1)
        return Shifted(
            c=mid[:, 1:-1], e=ext2[3:-1, 1:-1], w=ext2[1:-3, 1:-1],
            n=mid[:, 2:], s=mid[:, :-2],
            ee=ext2[4:, 1:-1], ww=ext2[:-4, 1:-1],
            nn=cp[:, 4:], ss=cp[:, :-4],
        )

    def apply_bc_y(x_own, var_k: int):
        return _apply_bc_y(x_own, bcs[var_k])

    def convection(ext, ff_r, signs):
        """(Fc, the (c, e, w, n, s) views) over the region ext[d:-d]."""
        if quick:
            s2 = shifts2_of(ext)
            return (quick_flux(None, ff_r, signs, shifts=s2),
                    (s2.c, s2.e, s2.w, s2.n, s2.s))
        sh1 = shifts1(ext)
        return upwind_flux(None, ff_r, signs, shifts=sh1), sh1

    def momentum_residual_fn(c_old, ff_r, nu):
        """(ext, lo, hi) -> (r, ap) of the momentum equation over the
        region of ext, the constants' region rows lo:hi."""
        signs = flux_signs(ff_r)
        ap = momentum_diag(ff_r, st.scheme, dx, dy, dt, nu, volp, signs)

        def fn(ext, lo, hi):
            sl = FaceFluxes(*(f[lo:hi] for f in ff_r))
            fc, sh1 = convection(ext, sl, tuple(s[lo:hi] for s in signs))
            fd, _ = diffusion(None, dx, dy, volp, shifts=sh1)
            r = -(volp / dt * (sh1[0] - c_old[lo:hi]) + fc - nu * fd)
            return r, ap[lo:hi]

        return fn

    def check_loop(f, run_check, check_every: int):
        """The inner loop of `sweeps.sweep_loop` on globally summed rms:
        `run_check(f) -> (f, rms)` runs `check_every` sweeps. Returns
        (f, sweeps_run)."""
        rms = best = t(np.inf)
        tol = t(st.inner_tolerance)
        stale = checks = it = 0
        while it < st.inner_max_iter and rms >= tol and not stalled(stale, checks):
            f, now = run_check(f)
            stale, best = stall_update(now, rms, best, stale)
            rms = now
            checks += 1
            it += check_every
        return f, it

    def sweep_solve(x_own, residual_fn, sor, check_every: int):
        """Exchange every half-sweep (QUICK bands of 2 rows)."""

        def sweep(f, with_rms):
            f = f.clone()
            r1, ap1 = residual_fn(f)
            f[:, 1:-1] += torch.where(red_own, sor * r1 / ap1, 0.0)
            r2, ap2 = residual_fn(f)
            f[:, 1:-1] += torch.where(red_own, 0.0, sor * r2 / ap2)
            if not with_rms:
                return f, None
            ss = ring.psum(torch.sum(torch.where(red_own, r1 * r1, r2 * r2)).reshape(1),
                           group)
            return f, rms_of_sum(ss, n_cells, dtype)

        def run_check(f):
            for _ in range(check_every - 1):
                f, _ = sweep(f, False)
            return sweep(f, True)

        return check_loop(x_own, run_check, check_every)

    # communication-avoiding sweeps: with r_s / b_s the invalid depth of
    # red / black after sweep s and d the stencil radius,
    # r_s = max(b_{s-1} + 1, r_{s-1} + d), b_s = max(r_s + 1, b_{s-1} + d),
    # so r_s = d s, b_s = d s + 1 for d = 2 (QUICK) and r_s = 2s - 1,
    # b_s = 2s for d = 1: own rows (and the last sweep's own residuals) are
    # exact iff H >= 2k + (1 if d == 2 else 0). Own-cell updates read the
    # same values in the same order as the exchange-per-half-sweep
    # schedule, so the trajectories are the same bit for bit.
    d_mom = 2 if quick else 1
    k_max_mom = (rows - (1 if quick else 0)) // 2

    def extend_consts(cs, H: int):
        """(n, rows + 2H, ny): one stacked exchange for every constant's
        H-row bands. Boundary ranks get zeros on the open side, read only
        at out-of-domain rows whose updates the domain mask discards."""
        arr = torch.stack(cs)
        up, dn = ring.ring_exchange(arr[:, -H:], arr[:, :H], group)
        return torch.cat([up, arr, dn], dim=1)

    @functools.lru_cache(maxsize=None)
    def region_masks(H: int, d: int):
        nreg = rows + 2 * H - 2 * d
        gi = torch.arange(nreg, device=device)[:, None] + rank * rows - H + d
        jj = torch.arange(ny, device=device)[None, :] + 1
        red = (gi + 1 + jj) % 2 == 0
        dom = (gi >= 0) & (gi < nx)
        return red & dom, ~red & dom

    def ca_sweep_solve(x_own, make_residual, sor, check_every: int, d: int,
                       glow, ghigh, block_override=None):
        """`sweep_solve` with one exchange per block of sweeps.
        `make_residual(H_max) -> fn(ext, lo, hi) -> (r, ap)` evaluates the
        point residual over an extended block's region ext[d:-d], reading
        the constants' rows lo:hi of the H_max region.
        `block_override(f, kb, with_rms) -> (f, rms | None)` replaces the
        whole block (the per-rank kernel path). Returns (f, sweeps_run)."""
        extra = 1 if d == 2 else 0
        blocks = sweep_blocks(check_every, (rows - extra) // 2)
        H_max = 2 * blocks[0] + extra
        residual = None if block_override is not None else make_residual(H_max)

        def block_sweeps(f, kb: int, with_rms: bool):
            H = 2 * kb + extra
            fe = assemble(f, H, glow, ghigh)
            lo = H_max - H
            hi = lo + rows + 2 * H - 2 * d
            red_r, blk_r = region_masks(H, d)
            rms = None
            for j in range(kb):
                r1, ap1 = residual(fe, lo, hi)
                fe[d:-d, 1:-1] += torch.where(red_r, sor * r1 / ap1, 0.0)
                r2, ap2 = residual(fe, lo, hi)
                fe[d:-d, 1:-1] += torch.where(blk_r, sor * r2 / ap2, 0.0)
                if with_rms and j == kb - 1:
                    o = H - d
                    a, b = r1[o:o + rows], r2[o:o + rows]
                    ss = ring.psum(torch.sum(torch.where(red_own, a * a, b * b)).reshape(1),
                                   group)
                    rms = rms_of_sum(ss, n_cells, dtype)
            return fe[H:-H], rms

        block = block_override if block_override is not None else block_sweeps

        def run_check(f):
            rms = None
            for bi, kb in enumerate(blocks):
                f, r = block(f, kb, bi == len(blocks) - 1)
                if r is not None:
                    rms = r
            return f, rms

        return check_loop(x_own, run_check, check_every)

    def under_relax_own(x_own, old_own, a):
        if a == 1.0:
            return x_own
        out = x_own.clone()
        out[:, 1:-1] = old_own + a * (x_own[:, 1:-1] - old_own)
        return out

    def solve_mom(s: SpmdState, x, old_own, var_k: int, nu):
        glow, ghigh = ghosts(x, var_k)
        if k_max_mom >= 1:
            consts = [old_own, s.ff.e, s.ff.n, s.ff.w, s.ff.s]

            def make_residual(H_max):
                cr = extend_consts(consts, H_max)[:, d_mom:-d_mom]
                return momentum_residual_fn(cr[0], FaceFluxes(*cr[1:]), nu)

            return ca_sweep_solve(x, make_residual, 1.0, st.momentum_check_every,
                                  d_mom, glow, ghigh)
        # QUICK bands of 2 rows: exchange every half-sweep
        fn = momentum_residual_fn(old_own, s.ff, nu)
        h = 2 if quick else 1

        def residual(f):
            return fn(assemble(f, h, glow, ghigh), 0, rows)

        return sweep_solve(x, residual, 1.0, st.momentum_check_every)

    def solve_p(s: SpmdState, ff: FaceFluxes):
        """(p band, sweeps or V-cycles run) from the frozen ghosts at entry."""
        glow_p, ghigh_p = ghosts(s.p, 2)
        div_sum = ff.divergence_sum()
        if use_mg_p:
            # the frozen ghost ring's off-diagonal terms folded into the
            # right-hand side: a homogeneous-Dirichlet interior V-cycle
            inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
            fold = torch.zeros_like(div_sum)
            fold[:, 0] += inv_dy2 * s.p[:, 0]
            fold[:, -1] += inv_dy2 * s.p[:, -1]
            if first:
                fold[0, :] += inv_dx2 * glow_p[1:-1]
            if last:
                fold[-1, :] += inv_dx2 * ghigh_p[1:-1]
            b_eff = rho / dt * div_sum - volp * fold
            x, cycles = mg_solve(s.p[:, 1:-1], b_eff)
            p = s.p.clone()
            p[:, 1:-1] = x
            return p, cycles
        if use_pallas_p:
            # row 9: one 2kb-row exchange, then kb sweeps on the card
            from .spmd_kernels import extend_b_halo, shard_rb_sweep

            p_blocks = sweep_blocks(st.pressure_check_every, rows // 2)
            h_max = 2 * p_blocks[0]
            b_ext_full = extend_b_halo(rho / dt * div_sum, group, h=h_max)
            kernel_kw = dict(nxg=nx, inv_dx2=1.0 / (dx * dx), inv_dy2=1.0 / (dy * dy),
                             volp=volp, sor=p_sor)

            def block_kernel(f, kb, with_rms):
                h = 2 * kb
                ext = assemble(f, h, glow_p, ghigh_p)
                own, ss = shard_rb_sweep(ext, b_ext_full[h_max - h:h_max + rows + h],
                                         rank * rows, h=h, kb=kb, **kernel_kw)
                if not with_rms:
                    return own, None
                return own, rms_of_sum(ring.psum(ss.reshape(1), group), n_cells, dtype)

            return ca_sweep_solve(s.p, None, p_sor, st.pressure_check_every, 1,
                                  glow_p, ghigh_p, block_override=block_kernel)

        def make_residual(H_max):
            b_r = extend_consts([rho / dt * div_sum], H_max)[0, 1:-1]
            ap_d = -volp * (2.0 / (dx * dx) + 2.0 / (dy * dy))

            def fn(ext, lo, hi):
                fd, _ = diffusion(None, dx, dy, volp, shifts=shifts1(ext))
                return b_r[lo:hi] - fd, ap_d

            return fn

        return ca_sweep_solve(s.p, make_residual, p_sor, st.pressure_check_every,
                              1, glow_p, ghigh_p)

    crit = np.asarray([st.criterion("u"), st.criterion("v"), st.criterion("p")],
                      dtype=t)

    def step(s: SpmdState, nu):
        counts = {}
        with record_function("spmd.momentum"):
            u, counts["u"] = solve_mom(s, s.u, s.u_old, 0, nu)
            u = apply_bc_y(under_relax_own(u, s.u_old, alpha["u"]), 0)
            v, counts["v"] = solve_mom(s, s.v, s.v_old, 1, nu)
            v = apply_bc_y(under_relax_own(v, s.v_old, alpha["v"]), 1)

        # face fluxes from fresh ghosts (post-BC u, v)
        ff = face_fluxes(assemble(u, 1, *ghosts(u, 0)),
                         assemble(v, 1, *ghosts(v, 1)), dx, dy)

        with record_function("spmd.pressure"):
            p, counts["p"] = solve_p(s, ff)
            p = apply_bc_y(under_relax_own(p, s.p_old, alpha["p"]), 2)
        with record_function("spmd.rest"):
            return finish(s, u, v, p, ff, counts)

    def finish(s: SpmdState, u, v, p, ff, counts):
        """Projection, residuals, Rhie-Chow and the detectors."""
        # projection and residuals, fresh p ghosts
        pc, pe, pw, pn, ps = shifts1(assemble(p, 1, *ghosts(p, 2)))
        u = u.clone()
        v = v.clone()
        u[:, 1:-1] += -(dt / rho) * (pe - pw) / (2.0 * dx)
        v[:, 1:-1] += -(dt / rho) * (pn - ps) / (2.0 * dy)

        def sumsq(new, old):
            dd = new[:, 1:-1] - old
            return torch.sum(dd * dd)

        res = ring.psum(torch.stack([sumsq(u, s.u_old), sumsq(v, s.v_old),
                                     sumsq(p, s.p_old)]), group)
        u = apply_bc_y(u, 0)
        v = apply_bc_y(v, 1)

        c = dt / rho
        ff = FaceFluxes(
            e=ff.e - c * (pe - pc) * dy / dx,
            n=ff.n - c * (pn - pc) * dx / dy,
            w=ff.w - c * (pw - pc) * dy / dx,
            s=ff.s - c * (ps - pc) * dx / dy,
        )

        rms = (torch.sqrt(res / n_cells) / dt).cpu().numpy()
        count = s.count + 1
        crossed = bool(np.all(rms <= crit))

        # detectors, in the JAX step's order: sustained hold, field Cauchy
        # (pmax of the bands' drift), plateau window
        held = s.held
        converged = crossed
        if st.convergence_hold > 1:
            held = s.held + 1 if crossed else 0
            converged = held >= st.convergence_hold
        cau_u, cau_v, cau_count = s.cau_u, s.cau_v, s.cau_count
        if st.cauchy_tol > 0.0:
            at_check = count % st.cauchy_check_every == 0
            if at_check and count - s.cau_count >= st.cauchy_check_every:
                drift = ring.pmax(torch.stack([torch.max(torch.abs(u - s.cau_u)),
                                               torch.max(torch.abs(v - s.cau_v))]),
                                  group)
                converged = converged or bool(torch.all(drift < st.cauchy_tol))
            if at_check:
                cau_u, cau_v, cau_count = u, v, count
        plat_best, plat_acc = s.plat_best, s.plat_acc
        plat_n, plat_stale = s.plat_n, s.plat_stale
        if st.plateau_patience > 0:
            acc = s.plat_acc + rms
            wn = s.plat_n + 1
            at_check = count % st.plateau_check_every == 0
            mean = acc / t(max(wn, 1))
            improved = bool(np.any(mean < t(1.0 - st.plateau_rtol) * s.plat_best))
            if at_check:
                plat_stale = 0 if improved else s.plat_stale + 1
                plat_best = np.minimum(s.plat_best, mean)
                plat_acc, plat_n = np.zeros_like(acc), 0
            else:
                plat_acc, plat_n = acc, wn
            converged = converged or plat_stale >= st.plateau_patience

        return SpmdState(
            u=u, v=v, p=p, u_old=u[:, 1:-1], v_old=v[:, 1:-1], p_old=p[:, 1:-1],
            ff=ff, rms=rms, count=count, converged=converged,
            diverged=not bool(np.all(np.isfinite(rms))),
            held=held, plat_best=plat_best, plat_acc=plat_acc, plat_n=plat_n,
            plat_stale=plat_stale, cau_u=cau_u, cau_v=cau_v, cau_count=cau_count,
        ), counts

    return step


def _make_rre_stage(case: CaseConfig, profile, group):
    """Decomposed reduced-rank extrapolation, run after each step: the
    snapshot cadence, coefficient solve, plausibility gate and injection of
    the single-device loop, with the drift and the difference Gram summed
    over the ranks (pmax / psum of per-rank partials) and the K x K solve
    replicated. As in the JAX package, the Cauchy reference of the step
    that jumps holds the field from before the jump."""
    st = case.settings
    n_dev, rank = ring.size_of(group), ring.rank_of(group)
    flatten, inject, n_flat = _make_rre_ops(case, profile, n_dev, rank)
    K = st.rre_depth

    def stage(s: SpmdState, buf: rre.RREBuffer):
        if s.count % st.rre_every == 0 and s.count >= st.rre_min_count:
            buf = rre.push_snapshot(buf, flatten(s))
        if buf.count <= K:
            return s, buf
        snaps = buf.snaps
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            drift = ring.pmax(torch.max(torch.abs(snaps[-1] - snaps[-2])).reshape(1),
                              group)[0]
            scale = torch.clamp(drift, min=torch.finfo(snaps.dtype).tiny)
            Dn = (snaps[1:] - snaps[:-1]) / scale
            G = ring.psum(Dn @ Dn.T, group)
            x_star = rre.gram_coeffs(G) @ snaps[1:]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        # a non-finite local x_star makes the summed jump infinite
        jump_l = torch.where(torch.all(torch.isfinite(x_star)),
                             torch.max(torch.abs(x_star - snaps[-1])),
                             torch.tensor(float("inf"), dtype=snaps.dtype,
                                          device=snaps.device))
        jump = ring.pmax(jump_l.reshape(1), group)[0]
        ok = bool((torch.isfinite(jump) & (jump <= 1e3 * drift) & (drift > 0)).item())
        stage.taken += int(ok)
        if ok:
            s = inject(s, x_star)
        return s, buf._replace(count=0)

    stage.taken = 0  # jumps applied, so that a run can show one happened
    return stage, n_flat


class SpmdSolver:
    """Row-decomposed solver: the interior rows of the case split over the
    ranks of `group` (a process group, or a `mesh.Mesh` whose 'x' axis is
    taken; `nx % n_ranks == 0`), each rank running the SIMPLE step on its
    band with explicit halo exchange. Every rank constructs it and calls its
    methods in the same order (they hold collectives). Results match the
    single-device solver to the rounding of the sums. `device` defaults to
    the card ("cuda", an NCCL group); pass `device="cpu"` with a gloo group
    for the plain path."""

    def __init__(self, case: CaseConfig, group=None, device="cuda"):
        if isinstance(group, ring.Mesh):
            group = group.axis_group(AXIS)
        n_dev = ring.size_of(group)
        if case.mesh.nx % n_dev != 0:
            raise ValueError(
                f"nx = {case.mesh.nx} must divide over {n_dev} '{AXIS}' "
                f"devices (interior-row decomposition)"
            )
        if case.settings.spmd_devices not in (1, n_dev):
            raise ValueError(
                f"spmd_devices={case.settings.spmd_devices} does not match "
                f"the {n_dev}-device '{AXIS}' mesh: the config-time VMEM "
                "gate scaled the per-rank Pallas working set by a "
                "decomposition factor this mesh won't deliver"
            )
        if case.settings.pressure_solver not in ("sweeps", "multigrid"):
            raise ValueError(
                "SpmdSolver supports pressure_solver='sweeps' (reference-"
                "semantics inner loop) or 'multigrid' (sharded V-cycles, "
                f"parallel/spmd_mg.py); got {case.settings.pressure_solver!r}"
            )
        if case.settings.fused_step:
            raise ValueError("SpmdSolver shards the step; the fused "
                             "single-device whole-step kernel doesn't "
                             "apply (use_pallas=True runs the per-shard "
                             "Pallas pressure sweep instead)")
        self.device = resolve_device(device)
        ring.check_backend(self.device, group)
        self.case = case
        self.group = group
        self.n_ranks, self.rank = n_dev, ring.rank_of(group)
        self.rows = case.mesh.nx // n_dev
        self.profile = inlet_profile(case, self.device)
        self._step = _make_step(case, self.profile, group, self.device)
        self._rre_stage, self._n_flat = (
            _make_rre_stage(case, self.profile, group)
            if case.settings.rre_every > 0 else (None, 0))
        self._nu = torch.tensor(case.fluid.nu, dtype=torch_dtype(case),
                                device=self.device)
        self.local = self._to_local(init_state(case, self.device))
        from ..solver.simple import ResidualHistory

        self.residual_history = ResidualHistory()
        # inner sweeps (or V-cycles) summed over the steps run, and steps
        self.inner_counts = {"u": 0, "v": 0, "p": 0}
        self.steps_run = 0

    def _to_local(self, state: SolverState) -> SpmdState:
        """This rank's rows of a whole-domain state."""
        r0, r1 = self.rank * self.rows, (self.rank + 1) * self.rows

        def band(x):  # (nx + 2, ny + 2) -> own interior rows
            return x[1 + r0:1 + r1].clone()

        def part(x):  # (nx, ny) -> own rows
            return x[r0:r1].clone()

        return SpmdState(
            u=band(state.u), v=band(state.v), p=band(state.p),
            u_old=part(state.u_old), v_old=part(state.v_old),
            p_old=part(state.p_old), ff=FaceFluxes(*(part(f) for f in state.ff)),
            rms=state.rms.copy(), count=int(state.count),
            converged=bool(state.converged), diverged=bool(state.diverged),
            held=state.held, plat_best=state.plat_best.copy(),
            plat_acc=state.plat_acc.copy(), plat_n=state.plat_n,
            plat_stale=state.plat_stale, cau_u=band(state.cau_u_ref),
            cau_v=band(state.cau_v_ref), cau_count=state.cau_count,
        )

    def step(self) -> Dict[str, int]:
        """One outer step (no RRE, no chunk bookkeeping); returns its inner
        counts."""
        self.local, counts = self._step(self.local, self._nu)
        return counts

    def run_chunk(self) -> SpmdState:
        """Up to `chunk_size` outer steps; stops early on convergence,
        divergence or max_iterations. The RRE buffer is local to the chunk."""
        st = self.case.settings
        buf = None
        if self._rre_stage is not None:
            buf = rre.empty_buffer(st.rre_depth, self._n_flat,
                                   torch_dtype(self.case), self.device)
        s = self.local
        for _ in range(st.chunk_size):
            if s.converged or s.diverged or s.count >= st.max_iterations:
                break
            s, counts = self._step(s, self._nu)
            for k in counts:
                self.inner_counts[k] += counts[k]
            self.steps_run += 1
            if buf is not None:
                s, buf = self._rre_stage(s, buf)
        self.local = s
        return s

    def solve(self, max_chunks: Optional[int] = None) -> SpmdState:
        st = self.case.settings
        chunks = 0
        rms_window: list = []
        # each chunk runs >= 1 step unless the state is done, which ends
        # the loop, so max_iterations + 1 passes bound it
        for _ in range(st.max_iterations + 1):
            self.run_chunk()
            chunks += 1
            rms = self.local.rms
            self.residual_history.append(self.local.count, rms)
            done = (self.local.converged or self.local.diverged
                    or self.local.count >= st.max_iterations)
            if done or (max_chunks is not None and chunks >= max_chunks):
                break
            # host plateau window over chunk-boundary samples, as
            # CFDSolver.solve
            if st.plateau_patience > 0:
                rms_window.append(rms)
                n = st.plateau_patience
                if len(rms_window) >= 2 * n:
                    recent = np.median(rms_window[-n:], axis=0)
                    prior = np.median(rms_window[-2 * n:-n], axis=0)
                    if np.all(recent >= (1.0 - st.plateau_rtol) * prior):
                        break
                    rms_window = rms_window[-2 * n:]
        return self.local

    def global_fields(self) -> Dict[str, np.ndarray]:
        """{u, v, p} as whole padded (nx + 2, ny + 2) numpy arrays with the
        ghost ring derived again (the single-device state's layout). A
        collective: every rank calls it and gets the whole fields."""
        nx, ny = self.case.mesh.nx, self.case.mesh.ny
        out = {}
        for name, band, k, bc in (("u", self.local.u, 0, self.case.u_bc),
                                  ("v", self.local.v, 1, self.case.v_bc),
                                  ("p", self.local.p, 2, self.case.p_bc)):
            full = band.new_zeros((nx + 2, ny + 2))
            full[1:-1] = ring.all_gather(band, self.group)
            full = apply_bfs_inlet(apply_bc(full, bc), k, self.profile)
            out[name] = full.cpu().numpy()
        return out

    @property
    def Var(self) -> np.ndarray:
        f = self.global_fields()
        return np.stack([f["u"], f["v"], f["p"]])

    def interior_fields(self) -> Dict[str, np.ndarray]:
        """(ny, nx) interiors, as `SolverState.interior_fields`."""
        return {k: v[1:-1, 1:-1].T.copy() for k, v in self.global_fields().items()}

    def save_results(self, output_base_name: str) -> None:
        """The artifact suite of `io/results.save_all_results`, written by
        rank 0 (every rank calls it: the fields are gathered first)."""
        from ..io.results import save_all_results

        f = self.global_fields()
        if self.rank == 0:
            interior = {k: v[1:-1, 1:-1].T.copy() for k, v in f.items()}
            save_all_results(SimpleNamespace(
                case=self.case, Var=np.stack([f["u"], f["v"], f["p"]]),
                interior_fields=lambda: interior,
                residual_history=self.residual_history), output_base_name)

    def warm_start(self, fields: Dict[str, np.ndarray], count: int = 0) -> None:
        """Re-seed from (ny, nx) interior fields, as `CFDSolver.warm_start`:
        ghosts, olds and face fluxes derived again."""
        state = warm_start_state(self.case, fields, self.device)
        if count:
            state = state.replace(count=int(count))
        self.local = self._to_local(state)

    def checkpoint(self, path: str) -> None:
        """Write the whole state as the single-device solver's .npz snapshot
        (`io.checkpoint.save_solver_state`), from rank 0; every rank calls it
        (the fields are gathered first)."""
        from ..io.checkpoint import save_solver_state

        f = self.global_fields()
        if self.rank == 0:
            save_solver_state(path, SimpleNamespace(
                u=f["u"], v=f["v"], p=f["p"], count=self.local.count))

    def resume_from(self, path: str) -> None:
        """Resume from a .npz snapshot of either solver (fields and count)."""
        from ..io.checkpoint import load_solver_count, load_solver_fields

        self.warm_start(load_solver_fields(path), count=load_solver_count(path))


class SpmdWorkflowAdapter:
    """`CFDSolver`'s surface over a `SpmdSolver`, for the hybrid workflow
    (`workflow/hybrid.py`): the fine phases of the reference experiment run
    row-decomposed behind the warm_start / precompile / solve / artifact
    calls the workflow makes. `.mesh` is the case's MeshParameters, as on
    `CFDSolver`; the ranks are those of `.spmd.group`. Every rank makes the
    same calls; the artifacts are written from rank 0."""

    def __init__(self, solver: SpmdSolver):
        self.spmd = solver
        self.case = solver.case

    @property
    def mesh(self):
        return self.case.mesh

    @property
    def fluid(self):
        return self.case.fluid

    @property
    def settings(self):
        return self.case.settings

    @property
    def Var(self) -> np.ndarray:
        return self.spmd.Var

    @property
    def residual_history(self):
        return self.spmd.residual_history

    def interior_fields(self) -> Dict[str, np.ndarray]:
        return self.spmd.interior_fields()

    def warm_start(self, fields: Dict[str, np.ndarray], count: int = 0) -> None:
        self.spmd.warm_start(fields, count=count)

    def precompile(self) -> float:
        """The work the JAX package's AOT compile stands for, kept out of
        the timed solve: on the card the kernel library is loaded and one
        step from the state is run and discarded (each kernel's first
        launch, row 9's parameter blocks, the V-cycle's transfer
        operators). Returns the seconds spent."""
        t0 = time.perf_counter()
        s = self.spmd
        if s.device.type == "cuda":
            if s.case.settings.use_pallas:
                from ..ops.kernel_lib import load_library

                load_library()
            s._step(s.local, s._nu)
            torch.cuda.synchronize(s.device)
        return time.perf_counter() - t0

    def solve(self, output_base_name: str, verbose: bool = True,
              save_results: bool = True, **_ignored):
        """(iterations, elapsed seconds), writing `CFDSolver.solve`'s
        artifact suite from rank 0; raises `DivergenceError` on a
        non-finite residual."""
        t0 = time.time()
        local = self.spmd.solve()
        if self.spmd.device.type == "cuda":
            torch.cuda.synchronize(self.spmd.device)
        elapsed = time.time() - t0
        if local.diverged:
            from ..solver.simple import DivergenceError

            raise DivergenceError(
                f"Solution diverged at iteration {int(local.count)}: "
                f"RMS = {np.asarray(local.rms).tolist()} (NaN/Inf)."
            )
        if verbose and ring.is_rank0():
            print(f"\nSimulation completed in {elapsed:.2f} seconds "
                  f"({{'{AXIS}': {self.spmd.n_ranks}}} device mesh)")
            print(f"Total iterations: {int(local.count)}")
        if save_results:
            self.spmd.save_results(output_base_name)
        return int(local.count), elapsed
