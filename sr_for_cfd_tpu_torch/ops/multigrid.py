"""Geometric multigrid pressure solver, plain PyTorch (counterpart of `sr_for_cfd_tpu/ops/multigrid.py`).

Solves the frozen-ghost pressure system A x = b - L_ghost(p_ghost) with
V-cycles on an anisotropy-aware semi-coarsened hierarchy (`_levels`):
red-black SOR smoothing, residual restriction R r Rc^T times the
cell-agglomeration scale, and the mirrored prolongation. The transfer
matrices are those of `jax.image.resize(method='linear')` with
antialiasing, built from the same numpy formula as
`sr_for_cfd_tpu/ops/pallas_mg.py:_resize_matrix`; where a level halves
exactly along x, the row transfer is the equivalent [1,3,3,1] / 8
restriction and [0.75, 0.25] prolongation, as in the TPU kernel.

`mg_solve_pressure` is the plain version of the CUDA V-cycle kernel in
`ops/mg_kernels.py`, and the float64 validation path. The host reads the
fine-level rms once per cycle and applies the stall policy; the loop exits
exactly as `mg_while_loop` does: `it < max_cycles and best >= tol and not
stalled(stale, it)`.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stencil import FaceFluxes
from .sweeps import np_scalar_type, stall_update, stalled

MG_MAX_CYCLES = 30
MG_SMOOTHER_SOR = 1.5


def _levels(nx: int, ny: int, dx: float = 1.0, dy: float = 1.0,
            min_size: int = 8) -> List[Tuple[int, int]]:
    """Coarsening schedule: halve only the strongly-coupled direction until
    the level is near-isotropic (spacing ratio within 2x), then both."""
    sizes = [(nx, ny)]
    sp = [(dx, dy)]
    while min(sizes[-1]) > min_size:
        nxl, nyl = sizes[-1]
        dxl, dyl = sp[-1]
        if dxl > 2.0 * dyl and nyl > min_size:
            nxl2, nyl2 = nxl, max(2, nyl // 2)
        elif dyl > 2.0 * dxl and nxl > min_size:
            nxl2, nyl2 = max(2, nxl // 2), nyl
        else:
            nxl2, nyl2 = max(2, nxl // 2), max(2, nyl // 2)
        sizes.append((nxl2, nyl2))
        sp.append((dxl * nxl / nxl2, dyl * nyl / nyl2))
    return sizes


@functools.lru_cache(maxsize=None)
def _resize_matrix_f64(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) matrix of `jax.image.resize(..., 'linear')` along
    one axis: triangle kernel, antialiased when downsampling."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
        w / np.where(tot != 0, tot, 1.0),
        0.0,
    )
    valid = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(valid[None, :], w, 0.0)
    return np.ascontiguousarray(w.T)


def _resize_matrix(n_in: int, n_out: int, dtype=np.float32) -> np.ndarray:
    """`_resize_matrix_f64` in `dtype` (float32 gives the TPU kernel's
    matrices bit for bit)."""
    return _resize_matrix_f64(n_in, n_out).astype(dtype)


class LevelSetup(NamedTuple):
    """Static hierarchy: sizes, (1/dx^2, 1/dy^2) and volp per level, and
    the restriction scale of each transition."""

    sizes: Tuple[Tuple[int, int], ...]
    spacings: Tuple[Tuple[float, float], ...]
    volp_levels: Tuple[float, ...]
    scales: Tuple[float, ...]


@functools.lru_cache(maxsize=32)
def level_setup(nx, ny, dx, dy, volp, min_size=8) -> LevelSetup:
    sizes = tuple(_levels(nx, ny, dx, dy, min_size=min_size))
    spacings, volp_levels, scales = [], [], []
    for lvl, (nxl, nyl) in enumerate(sizes):
        dxl = dx * nx / nxl
        dyl = dy * ny / nyl
        spacings.append((1.0 / (dxl * dxl), 1.0 / (dyl * dyl)))
        # level 0 uses the caller's volp verbatim: the smoothed system is
        # exactly the one the rms check measures
        volp_levels.append(volp if lvl == 0 else dxl * dyl)
        if lvl + 1 < len(sizes):
            nc, mc = sizes[lvl + 1]
            scales.append((nxl / nc) * (nyl / mc))
    return LevelSetup(sizes, tuple(spacings), tuple(volp_levels),
                      tuple(scales))


def transfer_matrices(setup: LevelSetup, np_dtype):
    """Per transition (R_row (nc, nf), Rc_T (mf, mc), P_row (nf, nc),
    Pc_T (mc, mf)) as numpy arrays, None where the axis is not coarsened."""
    out = []
    for lvl in range(len(setup.sizes) - 1):
        nf, mf = setup.sizes[lvl]
        nc, mc = setup.sizes[lvl + 1]
        rows = nf != nc
        cols = mf != mc
        out.append((
            _resize_matrix(nf, nc, np_dtype) if rows else None,
            _resize_matrix(mf, mc, np_dtype).T.copy() if cols else None,
            _resize_matrix(nc, nf, np_dtype) if rows else None,
            _resize_matrix(mc, mf, np_dtype).T.copy() if cols else None,
        ))
    return out


def ghost_fold(ghost_only, inv_dx2, inv_dy2, volp):
    """Ghost-ring contribution to the interior RHS of the frozen-ghost
    system (`ghost_only` is the padded field with the interior zeroed)."""
    return volp * (
        (ghost_only[2:, 1:-1] + ghost_only[:-2, 1:-1]) * inv_dx2
        + (ghost_only[1:-1, 2:] + ghost_only[1:-1, :-2]) * inv_dy2
    )


def frozen_ghost_rhs(p: torch.Tensor, ff: FaceFluxes, dt: float, rho: float,
                     volp: float, inv_dx2: float, inv_dy2: float) -> torch.Tensor:
    """Interior RHS with the frozen ghost ring folded in."""
    b = (rho / dt) * ff.divergence_sum()
    ghost_only = p.clone()
    ghost_only[1:-1, 1:-1] = 0.0
    return b - ghost_fold(ghost_only, inv_dx2, inv_dy2, volp)


def lap(x: torch.Tensor, inv_dx2: float, inv_dy2: float, volp: float):
    """volp-scaled 5-point Laplacian, homogeneous-Dirichlet exterior."""
    xp = F.pad(x, (1, 1, 1, 1))
    c = xp[1:-1, 1:-1]
    return volp * (
        (xp[2:, 1:-1] - 2.0 * c + xp[:-2, 1:-1]) * inv_dx2
        + (xp[1:-1, 2:] - 2.0 * c + xp[1:-1, :-2]) * inv_dy2
    )


def red_mask(n: int, m: int, device) -> torch.Tensor:
    ii = torch.arange(n, device=device)[:, None]
    jj = torch.arange(m, device=device)[None, :]
    return (ii + jj) % 2 == 0


def row_restrict_exact2x(r: torch.Tensor, nc: int) -> torch.Tensor:
    """[1,3,3,1] stride-2 row restriction, 1/8 inside and 1/7 on the two
    boundary rows: the row action of `_resize_matrix(2nc, nc)`."""
    m = r.shape[1]
    zr = torch.zeros((1, m), dtype=r.dtype, device=r.device)
    half = torch.cat([zr, r, zr], dim=0).reshape(nc + 1, 2, m)
    ev, od = half[:, 0], half[:, 1]
    u = ev[:-1] + 3.0 * od[:-1] + 3.0 * ev[1:] + od[1:]
    w = torch.full((nc, 1), 1.0 / 8.0, dtype=r.dtype, device=r.device)
    w[0] = w[-1] = 1.0 / 7.0
    return u * w


def row_prolong_exact2x(e: torch.Tensor) -> torch.Tensor:
    """[0.75, 0.25] two-tap row prolongation with edge replication: the row
    action of `_resize_matrix(nc, 2nc)`."""
    nc, m = e.shape
    ep = torch.cat([e[:1], e, e[-1:]], dim=0)
    em1, em, ep1 = ep[:-2], ep[1:-1], ep[2:]
    c_even = 0.75 * em + 0.25 * em1
    c_odd = 0.75 * em + 0.25 * ep1
    return torch.stack([c_even, c_odd], dim=1).reshape(2 * nc, m)


class _Ops:
    """Level operators of one hierarchy (the plain counterpart of
    `make_level_ops` in the TPU kernel)."""

    def __init__(self, setup: LevelSetup, dtype, device, n_pre, n_post, sor,
                 coarsest_sweeps):
        self.setup = setup
        self.n_pre, self.n_post, self.sor = n_pre, n_post, sor
        self.coarsest_sweeps = coarsest_sweeps
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.mats = [
            tuple(None if a is None else torch.as_tensor(a, device=device)
                  for a in quad)
            for quad in transfer_matrices(setup, np_dtype)
        ]
        self.masks = [red_mask(n, m, device) for (n, m) in setup.sizes]

    def lap(self, x, lvl):
        inv_dx2, inv_dy2 = self.setup.spacings[lvl]
        return lap(x, inv_dx2, inv_dy2, self.setup.volp_levels[lvl])

    def smooth(self, x, b, lvl, n_sweeps, omega):
        inv_dx2, inv_dy2 = self.setup.spacings[lvl]
        inv_ap = omega / (-self.setup.volp_levels[lvl]
                          * (2.0 * inv_dx2 + 2.0 * inv_dy2))
        red = self.masks[lvl]
        for _ in range(n_sweeps):
            r = b - self.lap(x, lvl)
            x = x + torch.where(red, r * inv_ap, 0.0)
            r = b - self.lap(x, lvl)
            x = x + torch.where(red, 0.0, r * inv_ap)
        return x

    def v_cycle(self, x, b, lvl):
        sizes = self.setup.sizes
        if lvl + 1 >= len(sizes):
            return self.smooth(x, b, lvl, self.coarsest_sweeps, 1.5)
        x = self.smooth(x, b, lvl, self.n_pre, self.sor)
        r_c = self.restrict(b - self.lap(x, lvl), lvl)
        e_c = self.v_cycle(torch.zeros_like(r_c), r_c, lvl + 1)
        x = x + self.prolong(e_c, lvl)
        return self.smooth(x, b, lvl, self.n_post, self.sor)

    def _exact2x(self, lvl):
        nf, nc = self.setup.sizes[lvl][0], self.setup.sizes[lvl + 1][0]
        return nc * 2 == nf, nc

    def restrict(self, r, lvl):
        """Level lvl's residual -> level lvl + 1's right-hand side."""
        r_row, rc_t, _, _ = self.mats[lvl]
        exact2x, nc = self._exact2x(lvl)
        if r_row is not None:
            r = row_restrict_exact2x(r, nc) if exact2x else r_row @ r
        if rc_t is not None:
            r = r @ rc_t
        return r * self.setup.scales[lvl]

    def prolong(self, e_c, lvl):
        """Level lvl + 1's correction -> level lvl."""
        _, _, p_row, pc_t = self.mats[lvl]
        if pc_t is not None:
            e_c = e_c @ pc_t
        if p_row is not None:
            e_c = row_prolong_exact2x(e_c) if self._exact2x(lvl)[0] else p_row @ e_c
        return e_c


def mg_solve_pressure(
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
    """V-cycles to the residual-RMS tolerance; returns (p, cycles_run)."""
    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    setup = level_setup(nx, ny, dx, dy, volp, min_size)
    ops = _Ops(setup, p.dtype, p.device, n_pre, n_post, smoother_sor,
               coarsest_sweeps)
    inv_dx2, inv_dy2 = setup.spacings[0]
    b = frozen_ghost_rhs(p, ff, dt, rho, volp, inv_dx2, inv_dy2)
    x = p[1:-1, 1:-1]
    n_cells = nx * ny

    t = np_scalar_type(p.dtype)
    rms = best = t(np.inf)
    tol_t = t(tol)
    stale = it = 0
    while it < max_cycles and best >= tol_t and not stalled(stale, it):
        x = ops.v_cycle(x, b, 0)
        r = b - ops.lap(x, 0)
        now = t(torch.sqrt(torch.sum(r * r) / n_cells).item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        it += 1
    out = p.clone()
    out[1:-1, 1:-1] = x
    return out, it
