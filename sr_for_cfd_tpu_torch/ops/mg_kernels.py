"""Multigrid V-cycle pressure loop on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_mg.py`).

`mg_solve_pressure_kernel` is the port of `pallas_mg_solve_pressure`: the
same level schedule, smoother, transfer operators and stall policy as the
plain `multigrid.mg_solve_pressure`, with each V-cycle stage a CUDA kernel
from `csrc/mg_vcycle.cu`. The host walks the levels recursively and reads
the fine-level rms once per cycle; the exit rule is `mg_while_loop`'s:
`it < max_cycles and best >= tol and not stalled(stale, it)`. Returns
(p, cycles_run).

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernels or raises. `mg_solve_pressure_kernel.launches` counts
kernel launches.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import kernel_lib
from .multigrid import (
    MG_MAX_CYCLES,
    MG_SMOOTHER_SOR,
    LevelSetup,
    frozen_ghost_rhs,
    level_setup,
    mg_solve_pressure,
    transfer_matrices,
)
from .stencil import FaceFluxes
from .sweeps import stall_update, stalled

# row transfer modes of mg_vcycle.cu's mg_row_transfer
ROW_BAND, ROW_RESTRICT_2X, ROW_PROLONG_2X, ROW_COPY = 0, 1, 2, 3


class BandMatrix(NamedTuple):
    """A transfer matrix on the device with the [lo, hi) range of the
    non-zero entries of each output (row of a row operator, column of a
    column operator)."""

    mat: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def _band(mat: np.ndarray, axis: int, device) -> BandMatrix:
    nz = mat != 0
    if axis == 1:  # column operator (m_in, m_out): band per output column
        nz = nz.T
    lo = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    hi = np.where(nz.any(axis=1), nz.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return BandMatrix(
        torch.as_tensor(np.ascontiguousarray(mat), device=device),
        torch.as_tensor(lo.astype(np.int32), device=device),
        torch.as_tensor(hi.astype(np.int32), device=device),
    )


class MGPlan(NamedTuple):
    """Static hierarchy plus, per transition, the row and column operators
    of restriction and prolongation on the device (None on an axis that is
    not coarsened; the row operators are also None where the exact-2x
    stencils apply)."""

    setup: LevelSetup
    row_restrict: List[Optional[BandMatrix]]
    col_restrict: List[Optional[BandMatrix]]
    row_prolong: List[Optional[BandMatrix]]
    col_prolong: List[Optional[BandMatrix]]
    row_mode: List[int]  # ROW_* restriction mode, -1 when rows are kept


@functools.lru_cache(maxsize=8)
def plan_hierarchy(nx: int, ny: int, dx: float, dy: float, volp: float,
                   min_size: int = 8, device: str = "cuda") -> MGPlan:
    """Same schedule and operators as `multigrid.mg_solve_pressure`."""
    setup = level_setup(nx, ny, dx, dy, volp, min_size)
    rr, cr, rp, cp, modes = [], [], [], [], []
    for lvl, (r_row, rc_t, p_row, pc_t) in enumerate(
            transfer_matrices(setup, np.float32)):
        nf, nc = setup.sizes[lvl][0], setup.sizes[lvl + 1][0]
        exact2x = r_row is not None and nc * 2 == nf
        if r_row is None:
            modes.append(-1)
        else:
            modes.append(ROW_RESTRICT_2X if exact2x else ROW_BAND)
        band = r_row is not None and not exact2x
        rr.append(_band(r_row, 0, device) if band else None)
        rp.append(_band(p_row, 0, device) if band else None)
        cr.append(None if rc_t is None else _band(rc_t, 1, device))
        cp.append(None if pc_t is None else _band(pc_t, 1, device))
    return MGPlan(setup, rr, cr, rp, cp, modes)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(counter, code: int, what: str) -> None:
    """Raise on a launch error, else count one launch on `counter` (the
    wrapper whose `.launches` it is)."""
    kernel_lib.check(code, what)
    counter.launches += 1


def smooth_halves(lib, stream, counter, x, b, n, m, inv_dx2, inv_dy2, volp,
                  inv_ap, n_sweeps) -> None:
    """n_sweeps in-place red-black sweeps of the (n, m) level x (pointers)."""
    for _ in range(n_sweeps):
        for color in (0, 1):
            launch(counter, lib.srcfd_mg_smooth_half(
                x, b, n, m, inv_dx2, inv_dy2, volp, inv_ap, color, stream),
                "mg_smooth_half")


class _Cycle:
    """Device buffers and launches of V-cycles entered at level `top`:
    x_top and b_top are that level's arrays; levels above it get no
    buffers."""

    def __init__(self, plan: MGPlan, x_top: torch.Tensor, b_top: torch.Tensor,
                 n_pre, n_post, sor, coarsest_sweeps, counter=None, top=0):
        # the wrapper whose `.launches` counts this cycle's launches
        self.counter = counter or mg_solve_pressure_kernel
        self.plan = plan
        self.setup = plan.setup
        self.n_pre, self.n_post, self.sor = n_pre, n_post, sor
        self.coarsest_sweeps = coarsest_sweeps
        self.lib = kernel_lib.load_library()
        self.stream = kernel_lib.stream_ptr(x_top.device)
        sizes = self.setup.sizes
        dev = x_top.device
        f32 = torch.float32
        above = [None] * top
        self.x = above + [x_top] + [torch.empty(s, dtype=f32, device=dev)
                                    for s in sizes[top + 1:]]
        self.b = above + [b_top] + [torch.empty(s, dtype=f32, device=dev)
                                    for s in sizes[top + 1:]]
        self.r = above + [torch.empty(s, dtype=f32, device=dev)
                          for s in sizes[top:-1]]
        # (coarse rows, fine cols) scratch between the row and column passes
        self.tmp = above + [torch.empty((sizes[l + 1][0], sizes[l][1]),
                                        dtype=f32, device=dev)
                            for l in range(top, len(sizes) - 1)]
        if top == 0:  # fine_rms
            n0, m0 = sizes[0]
            self.n_part = self.lib.srcfd_mg_partials(n0, m0)
            self.partials = torch.empty(self.n_part, dtype=f32, device=dev)
            self.rms_dev = torch.empty(1, dtype=f32, device=dev)

    def _launch(self, code: int, what: str) -> None:
        launch(self.counter, code, what)

    def smooth(self, lvl, n_sweeps, omega):
        n, m = self.setup.sizes[lvl]
        inv_dx2, inv_dy2 = self.setup.spacings[lvl]
        volp = self.setup.volp_levels[lvl]
        inv_ap = omega / (-volp * (2.0 * inv_dx2 + 2.0 * inv_dy2))
        smooth_halves(self.lib, self.stream, self.counter, _ptr(self.x[lvl]),
                      _ptr(self.b[lvl]), n, m, inv_dx2, inv_dy2, volp, inv_ap,
                      n_sweeps)

    def residual(self, lvl, r_out, partials):
        n, m = self.setup.sizes[lvl]
        inv_dx2, inv_dy2 = self.setup.spacings[lvl]
        self._launch(self.lib.srcfd_mg_residual(
            _ptr(self.x[lvl]), _ptr(self.b[lvl]), r_out, partials, n, m,
            inv_dx2, inv_dy2, self.setup.volp_levels[lvl], self.stream),
            "mg_residual")

    def _row(self, src, dst, n_in, n_out, m, mode, band, scale, acc):
        mat = lo = hi = None
        if band is not None:
            mat, lo, hi = _ptr(band.mat), _ptr(band.lo), _ptr(band.hi)
        self._launch(self.lib.srcfd_mg_row_transfer(
            src, dst, n_in, n_out, m, mode, mat, lo, hi, scale, acc,
            self.stream), "mg_row_transfer")

    def _col(self, src, dst, n, m_in, m_out, band, scale, acc):
        self._launch(self.lib.srcfd_mg_col_transfer(
            src, dst, n, m_in, m_out, _ptr(band.mat), _ptr(band.lo),
            _ptr(band.hi), scale, acc, self.stream), "mg_col_transfer")

    def restrict(self, lvl):
        """b[lvl+1] = (R r Rc^T) * scale."""
        (nf, mf), (nc, mc) = self.setup.sizes[lvl], self.setup.sizes[lvl + 1]
        scale = self.setup.scales[lvl]
        mode = self.plan.row_mode[lvl]
        col = self.plan.col_restrict[lvl]
        src, dst = _ptr(self.r[lvl]), _ptr(self.b[lvl + 1])
        if mode >= 0:
            mid = _ptr(self.tmp[lvl]) if col is not None else dst
            self._row(src, mid, nf, nc, mf, mode, self.plan.row_restrict[lvl],
                      1.0 if col is not None else scale, 0)
            src = mid
        if col is not None:
            self._col(src, dst, nc, mf, mc, col, scale, 0)

    def prolong_add(self, lvl):
        """x[lvl] += P_row e Pc^T, e = x[lvl+1]."""
        (nf, mf), (nc, mc) = self.setup.sizes[lvl], self.setup.sizes[lvl + 1]
        mode = self.plan.row_mode[lvl]
        col = self.plan.col_prolong[lvl]
        src, dst = _ptr(self.x[lvl + 1]), _ptr(self.x[lvl])
        if col is not None:
            mid = _ptr(self.tmp[lvl]) if mode >= 0 else dst
            self._col(src, mid, nc, mc, mf, col, 1.0, int(mode < 0))
            src = mid
        if mode >= 0:
            row_mode = ROW_BAND if mode == ROW_BAND else ROW_PROLONG_2X
            self._row(src, dst, nc, nf, mf, row_mode,
                      self.plan.row_prolong[lvl], 1.0, 1)

    def v_cycle(self, lvl=0):
        if lvl + 1 >= len(self.setup.sizes):
            self.smooth(lvl, self.coarsest_sweeps, 1.5)
            return
        self.smooth(lvl, self.n_pre, self.sor)
        self.residual(lvl, _ptr(self.r[lvl]), None)
        self.restrict(lvl)
        self.x[lvl + 1].zero_()
        self.v_cycle(lvl + 1)
        self.prolong_add(lvl)
        self.smooth(lvl, self.n_post, self.sor)

    def fine_rms(self) -> float:
        n, m = self.setup.sizes[0]
        self.residual(0, None, _ptr(self.partials))
        self._launch(self.lib.srcfd_rms_finalize(
            _ptr(self.partials), self.n_part, float(n * m),
            _ptr(self.rms_dev), self.stream), "rms_finalize")
        return self.rms_dev.item()


def mg_solve_pressure_kernel(
    p: torch.Tensor,
    ff: FaceFluxes,
    *,
    dx: float,
    dy: float,
    dt: float,
    rho: float,
    volp: float,
    tol: float = 1e-6,
    max_cycles: int = MG_MAX_CYCLES,
    n_pre: int = 4,
    n_post: int = 4,
    smoother_sor: float = MG_SMOOTHER_SOR,
    min_size: int = 8,
    coarsest_sweeps: int = 40,
) -> Tuple[torch.Tensor, int]:
    """V-cycle pressure solve; returns (p, cycles_run)."""
    kw = dict(dx=dx, dy=dy, dt=dt, rho=rho, volp=volp, tol=tol,
              max_cycles=max_cycles, n_pre=n_pre, n_post=n_post,
              smoother_sor=smoother_sor, min_size=min_size,
              coarsest_sweeps=coarsest_sweeps)
    if p.device.type == "cpu":
        return mg_solve_pressure(p, ff, **kw)
    kernel_lib.check_field(p, "multigrid")
    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    plan = plan_hierarchy(nx, ny, dx, dy, volp, min_size, str(p.device))
    inv_dx2, inv_dy2 = plan.setup.spacings[0]
    b = frozen_ghost_rhs(p, ff, dt, rho, volp, inv_dx2, inv_dy2).contiguous()
    x = p[1:-1, 1:-1].clone(memory_format=torch.contiguous_format)
    cyc = _Cycle(plan, x, b, n_pre, n_post, smoother_sor, coarsest_sweeps)

    t = np.float32
    rms = best = t(np.inf)
    tol32 = t(tol)
    stale = it = 0
    while it < max_cycles and best >= tol32 and not stalled(stale, it):
        cyc.v_cycle()
        now = t(cyc.fine_rms())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        it += 1
    out = p.clone()
    out[1:-1, 1:-1] = cyc.x[0]
    return out, it


mg_solve_pressure_kernel.launches = 0
