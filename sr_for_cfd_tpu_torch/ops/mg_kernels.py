"""Multigrid V-cycle pressure loop on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_mg.py`).

`mg_solve_pressure_kernel` is the port of `pallas_mg_solve_pressure`: the
same level schedule, smoother, transfer operators and stall policy as the
plain `multigrid.mg_solve_pressure`, on the kernels of
`csrc/mg_vcycle.cu`. One V-cycle (`_Cycle`) is the stage kernels of the
levels above the tail level t (`tail_level`), one launch of the one-block
tail that runs levels t.. in shared memory, and the fine residual's rms.
The whole cycle is captured once into a CUDA graph and replayed once per
cycle; the host reads the rms once per cycle. The exit rule is
`mg_while_loop`'s: `it < max_cycles and best >= tol and not stalled(stale,
it)`. Returns (p, cycles_run).

A cycle owns its buffers, so that its graph replays on stable pointers, and
is cached per setting (`cached_cycle`): every solve of a solver replays the
same graph. `_Cycle`'s private arguments `_tail=False, _graph=False` give
the stage-by-stage form without tail or graph, which the card gates hold
the cycle against, bit for bit; no setting reaches them.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernels or raises: a failed build, capture or launch is an
exception, never an eager or plain fallback.
`mg_solve_pressure_kernel.launches` counts the kernels run (a replay adds
its graph's kernels), `.replays` the graph launches.
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

# row transfer modes of mg_vcycle.cu's mg_row_transfer (mg_ops.cuh MG_ROW_*)
ROW_BAND, ROW_RESTRICT_2X, ROW_PROLONG_2X, ROW_COPY = 0, 1, 2, 3

# bytes of shared memory the tail's level arrays may take, and the most
# levels it runs: csrc/mg_vcycle.cu's MG_TAIL_SMEM_BUDGET and
# MG_TAIL_MAX_LEVELS
TAIL_SMEM_BUDGET = 160 * 1024
TAIL_MAX_LEVELS = 16


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


def tail_layout(sizes, t: int) -> Tuple[List[Tuple[int, int, int, int]], int]:
    """The tail's shared arrays from level t down: per level the offsets
    (floats) of x, b, r and the (coarse rows, fine columns) scratch, 0
    where a level has none (r on the coarsest, the scratch unless both
    axes are coarsened), and the total in floats."""
    off, out = 0, []
    for lvl in range(t, len(sizes)):
        n, m = sizes[lvl]
        x, b, r, tmp = off, off + n * m, 0, 0
        off += 2 * n * m
        if lvl + 1 < len(sizes):
            nc, mc = sizes[lvl + 1]
            r, off = off, off + n * m
            if nc != n and mc != m:
                tmp, off = off, off + nc * m
        out.append((x, b, r, tmp))
    return out, off


def tail_level(sizes, top: int = 0) -> Optional[int]:
    """The first level at or below `top` from which the tail's arrays fit
    TAIL_SMEM_BUDGET and its levels TAIL_MAX_LEVELS; None where not even
    the coarsest level fits (then every level runs on the stages)."""
    for t in range(top, len(sizes)):
        if (len(sizes) - t <= TAIL_MAX_LEVELS
                and 4 * tail_layout(sizes, t)[1] <= TAIL_SMEM_BUDGET):
            return t
    return None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _inv_ap(omega, volp, inv_dx2, inv_dy2) -> float:
    """The smoother's omega / ap (ap the Laplacian's diagonal)."""
    return omega / (-volp * (2.0 * inv_dx2 + 2.0 * inv_dy2))


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


class _Tally:
    """A counter of launches and replays that belongs to no wrapper: the
    kernels of a capture (none runs until a replay), or a gate's cycle."""

    def __init__(self):
        self.launches = self.replays = 0


class _Cycle:
    """One hierarchy's V-cycle on the card, entered at level `top`: its own
    buffers for levels top.. (stable pointers, so that a graph can replay
    on them), the tail level `t` and the captured graph.

    With top == 0 a cycle ends in the fine residual's rms (`rms_dev`); the
    caller fills x[0] and b[0]. With top > 0 it runs from a zero iterate on
    b[top] and ends in the correction x[top], prolonged along columns to
    level top-1's width (`e`) where that transition coarsens columns.

    `_tail=False` runs every level on the stage kernels, `_graph=False`
    launches one kernel at a time: the stage form the card gates compare
    with, never reached from a setting."""

    def __init__(self, plan: MGPlan, device, n_pre, n_post, sor, coarsest_sweeps,
                 counter=None, top=0, *, _tail=True, _graph=True):
        # the wrapper whose `.launches` and `.replays` count this cycle
        self.counter = counter or mg_solve_pressure_kernel
        self._count = self.counter
        self.plan = plan
        self.setup = plan.setup
        self.top = top
        self.n_pre, self.n_post, self.sor = n_pre, n_post, sor
        self.coarsest_sweeps = coarsest_sweeps
        self.device = torch.device(device)
        self.lib = kernel_lib.load_library()
        self.stream = None  # the stream the launches go to, read per cycle
        sizes = self.setup.sizes

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        above = [None] * top
        self.x = above + [zeros(s) for s in sizes[top:]]
        self.b = above + [zeros(s) for s in sizes[top:]]
        self.r = above + [zeros(s) for s in sizes[top:-1]]
        # (coarse rows, fine cols) scratch between the row and column passes
        self.tmp = above + [zeros((sizes[l + 1][0], sizes[l][1]))
                            for l in range(top, len(sizes) - 1)]
        self.t = tail_level(sizes, top) if _tail else None
        if self.t is not None:
            self.tail_args = self._tail_plan()
        self.e = None
        if top == 0:  # the fine rms
            n0, m0 = sizes[0]
            self.n_part = self.lib.srcfd_mg_partials(n0, m0)
            self.partials = zeros(self.n_part)
            self.rms_dev = zeros(1)
        elif plan.col_prolong[top - 1] is not None:
            self.e = zeros((sizes[top][0], sizes[top - 1][1]))
        self.graph = None
        self.kernels = None  # kernels per cycle of the graph
        if _graph:
            self.capture()

    def _tail_plan(self):
        """The tail launch's host arrays (`srcfd_mg_tail` in
        csrc/mg_vcycle.cu) and its shared bytes."""
        setup, plan, sizes = self.setup, self.plan, self.setup.sizes
        layout, floats = tail_layout(sizes, self.t)
        iprm, fprm, pprm = [], [], []
        for offsets, lvl in zip(layout, range(self.t, len(sizes))):
            n, m = sizes[lvl]
            inv_dx2, inv_dy2 = setup.spacings[lvl]
            volp = setup.volp_levels[lvl]
            row_mode, has_col, scale, bands = -1, 0, 1.0, [None] * 4
            omega = 1.5
            if lvl + 1 < len(sizes):
                row_mode = plan.row_mode[lvl]
                has_col = int(plan.col_restrict[lvl] is not None)
                scale = setup.scales[lvl]
                bands = [plan.row_restrict[lvl], plan.row_prolong[lvl],
                         plan.col_restrict[lvl], plan.col_prolong[lvl]]
                omega = self.sor
            iprm += [n, m, row_mode, has_col, *offsets]
            fprm += [inv_dx2, inv_dy2, volp,
                     _inv_ap(omega, volp, inv_dx2, inv_dy2), scale]
            for bm in bands:
                pprm += ([0, 0, 0] if bm is None else
                         [bm.mat.data_ptr(), bm.lo.data_ptr(), bm.hi.data_ptr()])
        return (np.asarray(iprm, np.int32), np.asarray(fprm, np.float32),
                np.asarray(pprm, np.uint64), 4 * floats)

    def _launch(self, code: int, what: str) -> None:
        launch(self._count, code, what)

    def zero(self, lvl):
        """x[lvl] = 0, a memset (not a kernel: not counted)."""
        kernel_lib.check(self.lib.srcfd_mg_zero(
            _ptr(self.x[lvl]), self.x[lvl].numel(), self.stream), "mg_zero")

    def smooth(self, lvl, n_sweeps, omega):
        n, m = self.setup.sizes[lvl]
        inv_dx2, inv_dy2 = self.setup.spacings[lvl]
        volp = self.setup.volp_levels[lvl]
        smooth_halves(self.lib, self.stream, self._count, _ptr(self.x[lvl]),
                      _ptr(self.b[lvl]), n, m, inv_dx2, inv_dy2, volp,
                      _inv_ap(omega, volp, inv_dx2, inv_dy2), n_sweeps)

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

    def tail(self):
        """Levels t.. in one block: x[t] updated from x[t] and b[t]."""
        iprm, fprm, pprm, nbytes = self.tail_args
        self._launch(self.lib.srcfd_mg_tail(
            _ptr(self.x[self.t]), _ptr(self.b[self.t]),
            len(self.setup.sizes) - self.t, iprm.ctypes.data, fprm.ctypes.data,
            pprm.ctypes.data, self.n_pre, self.n_post, self.coarsest_sweeps,
            nbytes, self.stream), "mg_tail")

    def v_cycle(self, lvl):
        if lvl == self.t:
            self.tail()
            return
        if lvl + 1 >= len(self.setup.sizes):
            self.smooth(lvl, self.coarsest_sweeps, 1.5)
            return
        self.smooth(lvl, self.n_pre, self.sor)
        self.residual(lvl, _ptr(self.r[lvl]), None)
        self.restrict(lvl)
        self.zero(lvl + 1)
        self.v_cycle(lvl + 1)
        self.prolong_add(lvl)
        self.smooth(lvl, self.n_post, self.sor)

    def body(self):
        """One cycle's launches, in order, on `self.stream`."""
        top, sizes = self.top, self.setup.sizes
        if top > 0:
            self.zero(top)
        self.v_cycle(top)
        if top == 0:
            n, m = sizes[0]
            self.residual(0, None, _ptr(self.partials))
            self._launch(self.lib.srcfd_rms_finalize(
                _ptr(self.partials), self.n_part, float(n * m),
                _ptr(self.rms_dev), self.stream), "rms_finalize")
        elif self.e is not None:
            self._col(_ptr(self.x[top]), _ptr(self.e), sizes[top][0],
                      sizes[top][1], sizes[top - 1][1],
                      self.plan.col_prolong[top - 1], 1.0, 0)

    def capture(self):
        """Capture one cycle into `self.graph`, after one eager cycle on
        the (zero) buffers that loads every kernel before the capture. A
        failure raises; nothing falls back."""
        self.stream = kernel_lib.stream_ptr(self.device)
        self.body()
        graph, tally = torch.cuda.CUDAGraph(), _Tally()
        self._count = tally
        try:
            with torch.cuda.graph(graph):
                # launches go to the capture stream
                self.stream = kernel_lib.stream_ptr(self.device)
                self.body()
        finally:
            self._count = self.counter
        self.graph, self.kernels = graph, tally.launches

    def run(self):
        """One V-cycle: a replay of the graph, or (graph-less form) the
        launches one by one on the current stream."""
        if self.graph is None:
            self.stream = kernel_lib.stream_ptr(self.device)
            self.body()
            return
        self.graph.replay()
        self.counter.launches += self.kernels
        self.counter.replays += 1

    def correction(self, b_top: torch.Tensor) -> torch.Tensor:
        """(top > 0) One cycle from zero for the right-hand side `b_top`,
        copied into the cycle's own b[top]; returns the correction, a
        buffer of the cycle that the next call overwrites."""
        self.b[self.top].copy_(b_top)
        self.run()
        return self.x[self.top] if self.e is None else self.e


@functools.lru_cache(maxsize=8)
def cached_cycle(nx, ny, dx, dy, volp, min_size, device: str, n_pre, n_post,
                 sor, coarsest_sweeps) -> _Cycle:
    """The V-cycle of one solve setting, built and captured once: every
    solve with this setting replays its graph (the cache holds the graph and
    its memory pool)."""
    plan = plan_hierarchy(nx, ny, dx, dy, volp, min_size, device)
    return _Cycle(plan, device, n_pre, n_post, sor, coarsest_sweeps)


def cycle_solve(cyc: _Cycle, p: torch.Tensor, ff: FaceFluxes, *, dt, rho,
                tol, max_cycles) -> Tuple[torch.Tensor, int]:
    """V-cycles of the top-level cycle `cyc` on p's frozen-ghost system to
    the rms tolerance; returns (p, cycles_run)."""
    inv_dx2, inv_dy2 = cyc.setup.spacings[0]
    volp = cyc.setup.volp_levels[0]  # the caller's volp
    cyc.b[0].copy_(frozen_ghost_rhs(p, ff, dt, rho, volp, inv_dx2, inv_dy2))
    cyc.x[0].copy_(p[1:-1, 1:-1])
    t = np.float32
    rms = best = t(np.inf)
    tol32 = t(tol)
    stale = it = 0
    while it < max_cycles and best >= tol32 and not stalled(stale, it):
        cyc.run()
        now = t(cyc.rms_dev.item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        it += 1
    out = p.clone()
    out[1:-1, 1:-1] = cyc.x[0]
    return out, it


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
    if p.device.type == "cpu":
        return mg_solve_pressure(
            p, ff, dx=dx, dy=dy, dt=dt, rho=rho, volp=volp, tol=tol,
            max_cycles=max_cycles, n_pre=n_pre, n_post=n_post,
            smoother_sor=smoother_sor, min_size=min_size,
            coarsest_sweeps=coarsest_sweeps)
    kernel_lib.check_field(p, "multigrid")
    cyc = cached_cycle(p.shape[0] - 2, p.shape[1] - 2, dx, dy, volp, min_size,
                       str(p.device), n_pre, n_post, smoother_sor,
                       coarsest_sweeps)
    return cycle_solve(cyc, p, ff, dt=dt, rho=rho, tol=tol, max_cycles=max_cycles)


mg_solve_pressure_kernel.launches = 0
mg_solve_pressure_kernel.replays = 0
