"""Streamed V-cycle pressure loop on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_stream.py`).

`stream_mg_solve_pressure` is the port of the TPU's `stream_mg_solve_pressure`
(`pallas_stream.py:671`), the multigrid pressure solve of `use_pallas` past
the big-grid threshold. Each V-cycle is three parts, each the port of one
TPU kernel:

* `stream_pass_a` (`_pass_a_kernel`, :168): n_pre red-black sweeps on the
  fine level, the rms of the residual at the cycle's ENTRY (taken from the
  first half-sweep, before any update), then the residual and its
  restriction: the [1,3,3,1] stride-2 row restriction with the per-row
  norms of `_row_restrict_norm` and the restriction scale, then the column
  restriction. Kernel: `csrc/stream_pass.cu`, all of it in one launch
  (`ops/stream_pass.py`).
* `level1_correction` (`_coarse_kernel`, :298): one V-cycle from a zero
  guess on levels 1.. of the same hierarchy, then the column prolongation.
  Kernels: `csrc/mg_vcycle.cu`'s (`ops/mg_kernels._Cycle` entered at level
  1): the stages of the levels above the tail, the one-block tail, the
  column prolongation, all replayed as one CUDA graph.
* `stream_pass_b` (`_pass_b_kernel`, :332): the [0.75, 0.25] row
  prolongation with edge replication added to the fine iterate, then
  n_post sweeps. Kernel: `csrc/stream_pass.cu`, in one launch.

The staged forms `stream_pass_a_staged` and `stream_pass_b_staged` are the
passes as stage launches (`csrc/stream_mg.cu`'s entry half-sweep and
residual with the row restriction, `csrc/mg_vcycle.cu`'s half-sweeps and
transfers: 11 and 9 launches at n = 4). The fused passes give their bits;
the card gates hold them to that, and an n past the fused kernel's halo
(`stream_pass.fits`) runs on them.

The loop exits as the TPU loop does (:753-768): `it < max_cycles and
best >= tol and not stalled(stale, it)`, where the rms fed to the stall
policy is the entry rms of the cycle just run. The check therefore lags one
cycle, and where both reach tolerance the count is one more than
`mg_solve_pressure`'s. The right-hand side has the frozen ghost ring folded
in (:738-740), and only the interior is written back (:775).

What the TPU's layouts decide is not ported, only what they refuse. Slab
height, the resident or recursive coarse correction
(`RESIDENT_SUB_CELLS_MAX`) and the wide hand-off (`WIDE_VMEM_BYTES`) only
decide where the TPU computes each level; the H100 has no VMEM wall, so
each stage here is one launch over the whole level. But the TPU package
refuses some settings for VMEM reasons (a halo wider than the slab, a grid
too wide for its transfer operators with too shallow a hierarchy), and the
wrapper raises the same `ValueError`s with the same texts
(`check_streamed_layout`), so that both packages accept the same
configurations. The column transfers here are true float32; the TPU's are a
bf16x3 split about 2^-18 off, so the two agree to ~1e-6, not bit for bit.

The plain versions (`*_plain`) follow the kernels' order of operations, on
`ops/multigrid.py`'s level operators. On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches its kernels or raises. The
`.launches` of `stream_pass_a`, `level1_correction` and `stream_pass_b`
count their kernels (a replay adds its graph's; a staged form counts on the
wrapper it serves), `level1_correction.replays` its graph launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import kernel_lib, stream_pass
from .mg_kernels import (
    ROW_COPY,
    ROW_PROLONG_2X,
    _Cycle,
    launch,
    plan_hierarchy,
    smooth_halves,
)
from .multigrid import (
    MG_MAX_CYCLES,
    MG_SMOOTHER_SOR,
    _Ops,
    frozen_ghost_rhs,
    level_setup,
    row_prolong_exact2x,
)
from .stencil import FaceFluxes
from .sweeps import stall_update, stalled

# The TPU kernel's default slab height (rows per grid step; a multiple of 16).
SLAB_ROWS = 256

# The TPU's slab envelope: R x W cells per slab that its streaming passes
# (and its tiled momentum kernel) can double-buffer through VMEM.
SLAB_CELLS_MAX = 256 * 4160

# The TPU's ceiling (cells) on the top level of its VMEM-resident coarse
# correction; past it the TPU recurses the streaming onto level 1.
RESIDENT_SUB_CELLS_MAX = 1_500_000

# The TPU's per-pass VMEM estimate (bytes) past which its passes switch to
# the wide hand-off layout.
WIDE_VMEM_BYTES = 50 * 1024 * 1024


def auto_slab_rows(requested: int, width: int) -> int:
    """Clamp a slab height so R x `width` stays inside SLAB_CELLS_MAX,
    halving (which keeps multiples of 16), not below 16 rows."""
    r = requested
    while r > 16 and r * width > SLAB_CELLS_MAX:
        r //= 2
    return max(16, r)


def check_streamed_layout(sizes: Sequence[Tuple[int, int]], R: int,
                          n_pre: int, n_post: int) -> None:
    """Raise where the TPU's `_make_streamed_cycle` refuses the hierarchy
    `sizes` at slab height R, following its recursion onto level 1."""
    nf, W = sizes[0]
    nc, mc = sizes[1]
    coarsen_x, coarsen_y = nf != nc, W != mc
    Ha = 2 * n_pre + 2
    Hb = 2 * n_post
    if Ha > R or Hb > R:
        raise ValueError("slab_rows too small for the smoother halos")
    n_blocks = 2 + -(-nf // R)
    n_data = n_blocks - 2
    ebase = (n_data * R // 2) if coarsen_x else (n_data * R)
    nc_pad = ebase + 2
    hbp = (Hb // 2 + 1) if coarsen_x else Hb
    e2_rows = ebase + 2 * hbp + 2
    est_a = 2 * (3 * R * W + (W * mc if coarsen_y else 0) + nc_pad * mc)
    est_b = 2 * (3 * R * W + e2_rows * W)
    est_scratch = 2 * R * W + 2 * Ha * W
    wide = (max(est_a, est_b) + est_scratch) * 4 > WIDE_VMEM_BYTES
    sub = sizes[1:]
    if wide and len(sub) < 2:
        raise ValueError(
            "grid too wide for in-kernel transfer operators but its "
            "hierarchy is too shallow to recurse; raise min_size levels"
        )
    if wide or (len(sub) >= 2 and sub[0][0] * sub[0][1] > RESIDENT_SUB_CELLS_MAX):
        check_streamed_layout(sub, R, n_pre, n_post)


class StreamLevels:
    """The hierarchy of one streamed solve: level sizes and scales, the
    restriction norms, the smoother's sor/ap, and on the device the
    transfer bands and V-cycle buffers (built at first use) or the plain
    level operators."""

    def __init__(self, nx, ny, dx, dy, volp, device, *, n_pre=4, n_post=4,
                 sor=MG_SMOOTHER_SOR, min_size=8, coarsest_sweeps=40):
        self.key = (nx, ny, dx, dy, volp, min_size)
        self.device = torch.device(device)
        self.setup = level_setup(nx, ny, dx, dy, volp, min_size)
        (self.nf, self.mf), (self.nc, self.mc) = self.setup.sizes[:2]
        self.coarsen_x = self.nf != self.nc
        self.coarsen_y = self.mf != self.mc
        scale = self.setup.scales[0]
        t = np.float32
        # _row_restrict_norm: scale/8 inside, scale/7 on the boundary rows
        self.norm_in = float(t(scale / 8.0) if self.coarsen_x else t(scale))
        self.norm_bd = float(t(scale / 7.0) if self.coarsen_x else t(scale))
        inv_dx2, inv_dy2 = self.setup.spacings[0]
        self.lap_coef = (inv_dx2, inv_dy2, self.setup.volp_levels[0])
        self.inv_ap = sor / (-self.setup.volp_levels[0]
                             * (2.0 * inv_dx2 + 2.0 * inv_dy2))
        self.n_pre, self.n_post, self.sor = n_pre, n_post, sor
        self.coarsest_sweeps = coarsest_sweeps
        self._ops: Optional[_Ops] = None
        self._cycle: Optional[_Cycle] = None
        self._partials: Optional[torch.Tensor] = None
        self._fused = {}

    @property
    def ops(self) -> _Ops:
        """Plain level operators (the plain versions' hierarchy)."""
        if self._ops is None:
            self._ops = _Ops(self.setup, torch.float32, self.device, self.n_pre,
                             self.n_post, self.sor, self.coarsest_sweeps)
        return self._ops

    @property
    def plan(self):
        """The transfer bands on the card (`mg_kernels.plan_hierarchy`)."""
        return plan_hierarchy(*self.key, str(self.device))

    @property
    def cycle(self) -> _Cycle:
        """The V-cycle of levels 1.. on the card, built and captured at
        first use; its kernels count on `level1_correction`."""
        if self._cycle is None:
            self._cycle = _Cycle(self.plan, self.device, self.n_pre, self.n_post,
                                 self.sor, self.coarsest_sweeps,
                                 counter=level1_correction, top=1)
        return self._cycle

    def fused(self, pass_: str) -> stream_pass.FusedPass:
        """The fused pass A ("a") or B ("b") of this hierarchy, built at
        first use."""
        if pass_ not in self._fused:
            self._fused[pass_] = stream_pass.FusedPass(self, pass_)
        return self._fused[pass_]

    @property
    def partials(self) -> torch.Tensor:
        """The staged entry half-sweep's per-block sums (mg_residual's
        grid)."""
        if self._partials is None:
            lib = kernel_lib.load_library()
            n = lib.srcfd_mg_partials(self.nf, self.mf)
            self._partials = torch.empty(n, dtype=torch.float32, device=self.device)
        return self._partials


@functools.lru_cache(maxsize=8)
def stream_levels(nx, ny, dx, dy, volp, device: str, n_pre, n_post, sor,
                  min_size, coarsest_sweeps) -> StreamLevels:
    """One StreamLevels per solve setting: the solver's every pressure
    solve reuses its hierarchy and buffers."""
    return StreamLevels(nx, ny, dx, dy, volp, device, n_pre=n_pre,
                        n_post=n_post, sor=sor, min_size=min_size,
                        coarsest_sweeps=coarsest_sweeps)


# ---- plain versions -------------------------------------------------------


def _row_restrict_unnormalized(r: torch.Tensor, nc: int) -> torch.Tensor:
    """The [1,3,3,1] stride-2 row sums, zero outside."""
    m = r.shape[1]
    zr = torch.zeros((1, m), dtype=r.dtype, device=r.device)
    half = torch.cat([zr, r, zr], dim=0).reshape(nc + 1, 2, m)
    ev, od = half[:, 0], half[:, 1]
    return ev[:-1] + 3.0 * od[:-1] + 3.0 * ev[1:] + od[1:]


def stream_pass_a_plain(x, b, lv: StreamLevels):
    """(x after n_pre sweeps, the level-1 right-hand side, the entry rms)."""
    ops = lv.ops
    red = ops.masks[0]
    r = b - ops.lap(x, 0)
    rms = torch.sqrt(torch.sum(r * r) / (lv.nf * lv.mf))
    x = x + torch.where(red, r * lv.inv_ap, 0.0)
    r = b - ops.lap(x, 0)
    x = x + torch.where(red, 0.0, r * lv.inv_ap)
    x = ops.smooth(x, b, 0, lv.n_pre - 1, lv.sor)
    r = b - ops.lap(x, 0)
    if lv.coarsen_x:
        w = torch.full((lv.nc, 1), lv.norm_in, dtype=r.dtype, device=r.device)
        w[0] = w[-1] = lv.norm_bd
        rows = _row_restrict_unnormalized(r, lv.nc) * w
    else:
        rows = r * lv.norm_in
    b1 = rows @ ops.mats[0][1] if lv.coarsen_y else rows
    return x, b1, rms


def level1_correction_plain(b1, lv: StreamLevels):
    """The column-prolonged correction (nc rows, mf columns)."""
    ops = lv.ops
    e = ops.v_cycle(torch.zeros_like(b1), b1, 1)
    return e @ ops.mats[0][3] if lv.coarsen_y else e


def stream_pass_b_plain(x, b, e, lv: StreamLevels):
    x = x + (row_prolong_exact2x(e) if lv.coarsen_x else e)
    return lv.ops.smooth(x, b, 0, lv.n_post, lv.sor)


# ---- the kernels ---------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_level(t: torch.Tensor, shape, what: str) -> None:
    """Raise unless `t` is what the fused passes take: a contiguous float32
    CUDA array of `shape`, 16-byte aligned."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"the fused streamed pass takes {what} as a contiguous, aligned "
                         f"float32 CUDA array of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def stream_pass_a(x: torch.Tensor, b: torch.Tensor, lv: StreamLevels):
    """Pass A; returns (x after n_pre sweeps, the level-1 right-hand side,
    the entry rms as a one-element tensor). Leaves `x` as it was. On the
    card one launch of the fused pass, or the staged form for an n_pre past
    its halo."""
    if x.device.type == "cpu":
        return stream_pass_a_plain(x, b, lv)
    if not stream_pass.fits("a", lv.n_pre):
        return stream_pass_a_staged(x, b, lv)
    for t, what in ((x, "x"), (b, "b")):
        _check_level(t, (lv.nf, lv.mf), what)
    fused = lv.fused("a")
    y = torch.empty_like(x)
    b1 = torch.empty(fused.out_shape, dtype=torch.float32, device=x.device)
    rms = torch.empty(1, dtype=torch.float32, device=x.device)
    launch(stream_pass_a, fused(x, y, b, b1=b1, rms=rms), "stream_pass_a")
    return y, b1, rms


def stream_pass_a_staged(x: torch.Tensor, b: torch.Tensor, lv: StreamLevels,
                         counter=None):
    """Pass A as stage launches (the fused pass's bit-equality reference);
    the launches count on `counter` (default `stream_pass_a`)."""
    lib = kernel_lib.load_library()
    stream = kernel_lib.stream_ptr(x.device)
    count = counter or stream_pass_a
    part = lv.partials
    n, m = lv.nf, lv.mf
    y = torch.empty_like(x)
    # the first half-sweep out of place: the entry residual of every cell
    # is taken before any update
    launch(count, lib.srcfd_sm_entry_half(
        _ptr(x), _ptr(y), _ptr(b), n, m, *lv.lap_coef, lv.inv_ap, _ptr(part),
        stream), "sm_entry_half")
    launch(count, lib.srcfd_mg_smooth_half(
        _ptr(y), _ptr(b), n, m, *lv.lap_coef, lv.inv_ap, 1, stream),
        "mg_smooth_half")
    smooth_halves(lib, stream, count, _ptr(y), _ptr(b), n, m, *lv.lap_coef,
                  lv.inv_ap, lv.n_pre - 1)
    rms = torch.empty(1, dtype=torch.float32, device=x.device)
    launch(count, lib.srcfd_rms_finalize(
        _ptr(part), part.numel(), float(n * m), _ptr(rms), stream),
        "rms_finalize")
    n_rows = lv.nc if lv.coarsen_x else n
    rows = torch.empty((n_rows, m), dtype=torch.float32, device=x.device)
    launch(count, lib.srcfd_sm_restrict_rows(
        _ptr(y), _ptr(b), _ptr(rows), n, m, n_rows, *lv.lap_coef,
        int(lv.coarsen_x), lv.norm_in, lv.norm_bd, stream), "sm_restrict_rows")
    if not lv.coarsen_y:
        return y, rows, rms
    band = lv.plan.col_restrict[0]
    b1 = torch.empty((n_rows, lv.mc), dtype=torch.float32, device=x.device)
    launch(count, lib.srcfd_mg_col_transfer(
        _ptr(rows), _ptr(b1), n_rows, m, lv.mc, _ptr(band.mat), _ptr(band.lo),
        _ptr(band.hi), 1.0, 0, stream), "mg_col_transfer")
    return y, b1, rms


def level1_correction(b1: torch.Tensor, lv: StreamLevels) -> torch.Tensor:
    """One V-cycle from zero on levels 1.. for the right-hand side `b1`,
    then the column prolongation; returns the correction (nc rows, mf
    columns). On the card the cycle is one replay of `lv.cycle`'s graph,
    and the correction is a buffer of it that the next call overwrites."""
    if b1.device.type == "cpu":
        return level1_correction_plain(b1, lv)
    return lv.cycle.correction(b1)


def stream_pass_b(x: torch.Tensor, b: torch.Tensor, e: torch.Tensor,
                  lv: StreamLevels) -> torch.Tensor:
    """Pass B: x + the row-prolonged correction, then n_post sweeps. On the
    card one launch of the fused pass into a new array (`x` is left as it
    was), or the staged form for an n_post past its halo, which updates `x`
    in place and returns it."""
    if x.device.type == "cpu":
        return stream_pass_b_plain(x, b, e, lv)
    if not stream_pass.fits("b", lv.n_post):
        return stream_pass_b_staged(x, b, e, lv)
    for t, what, shape in ((x, "x", (lv.nf, lv.mf)), (b, "b", (lv.nf, lv.mf)),
                           (e, "e", (lv.nc if lv.coarsen_x else lv.nf, lv.mf))):
        _check_level(t, shape, what)
    y = torch.empty_like(x)
    launch(stream_pass_b, lv.fused("b")(x, y, b, e=e), "stream_pass_b")
    return y


def stream_pass_b_staged(x: torch.Tensor, b: torch.Tensor, e: torch.Tensor,
                         lv: StreamLevels, counter=None) -> torch.Tensor:
    """Pass B as stage launches (the fused pass's bit-equality reference):
    `x` updated in place and returned; the launches count on `counter`
    (default `stream_pass_b`)."""
    lib = kernel_lib.load_library()
    stream = kernel_lib.stream_ptr(x.device)
    count = counter or stream_pass_b
    mode = ROW_PROLONG_2X if lv.coarsen_x else ROW_COPY
    launch(count, lib.srcfd_mg_row_transfer(
        _ptr(e), _ptr(x), e.shape[0], lv.nf, lv.mf, mode, None, None, None,
        1.0, 1, stream), "mg_row_transfer")
    smooth_halves(lib, stream, count, _ptr(x), _ptr(b), lv.nf, lv.mf,
                  *lv.lap_coef, lv.inv_ap, lv.n_post)
    return x


def streamed_cycle(x, b, lv: StreamLevels):
    """One V-cycle: (x after the cycle, the entry rms)."""
    x, b1, rms = stream_pass_a(x, b, lv)
    e = level1_correction(b1, lv)
    return stream_pass_b(x, b, e, lv), rms


def stream_mg_solve_pressure(
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
    slab_rows: int = SLAB_ROWS,
    return_count: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Streamed V-cycles (float32) to the entry-rms tolerance. With
    `return_count`, returns (p, cycles_run)."""
    if p.dtype != torch.float32:
        raise ValueError("stream_mg_solve_pressure is float32-only")
    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    if nx % 2 or ny % 2:
        raise ValueError("streamed multigrid needs even nx, ny")
    setup = level_setup(nx, ny, dx, dy, volp, min_size)
    if len(setup.sizes) < 2:
        raise ValueError("grid too small for a multigrid hierarchy")
    if n_pre < 1 or n_post < 1:
        raise ValueError("the streamed V-cycle needs n_pre >= 1 and "
                         "n_post >= 1 (entry-rms and halo widths are "
                         "built from the smoothing sweeps)")
    R = slab_rows
    if R % 16:
        raise ValueError("slab_rows must be a multiple of 16 (keeps the "
                         "restrict/prolong slice offsets (i-1)*R/2 "
                         "sublane-aligned for Mosaic)")
    # the TPU's slab height (its refusals depend on it; CFDSolver announces
    # a clamp, as the JAX package does)
    R = auto_slab_rows(R, ny)
    check_streamed_layout(setup.sizes, R, n_pre, n_post)
    if p.device.type != "cpu":
        kernel_lib.check_field(p, "streamed multigrid")
    lv = stream_levels(nx, ny, dx, dy, volp, str(p.device), n_pre, n_post,
                       smoother_sor, min_size, coarsest_sweeps)
    inv_dx2, inv_dy2 = setup.spacings[0]
    b = frozen_ghost_rhs(p, ff, dt, rho, volp, inv_dx2, inv_dy2).contiguous()
    x = p[1:-1, 1:-1].clone(memory_format=torch.contiguous_format)

    t = np.float32
    rms = best = t(np.inf)
    tol32 = t(tol)
    stale = it = 0
    while it < max_cycles and best >= tol32 and not stalled(stale, it):
        x, entry = streamed_cycle(x, b, lv)
        now = t(entry.item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        it += 1
    out = p.clone()
    out[1:-1, 1:-1] = x
    return (out, it) if return_count else out


stream_pass_a.launches = 0
level1_correction.launches = 0
level1_correction.replays = 0
stream_pass_b.launches = 0
