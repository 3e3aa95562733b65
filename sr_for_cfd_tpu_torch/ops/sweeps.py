"""Inner point-iteration sweeps, plain PyTorch (counterpart of `sr_for_cfd_tpu/ops/sweeps.py`).

Red-black (or Jacobi) sweeps until the residual RMS sqrt(sum R^2/(nx ny))
drops below `tol`, the unified stall policy fires, or `max_iter` sweeps
have run. Ghost cells are frozen during an inner solve.

The JAX package runs this loop inside `lax.while_loop`; here the host
runs it and reads the RMS once per check (`check_every` sweeps). The exit
decisions are computed in numpy scalars of the field's dtype, so they round
as the device-side comparisons of the JAX loop do and the sweep counts
agree. `solve_pressure` is also the plain version of the red-black SOR
kernel in `ops/pressure_kernels.py`.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..config import QUICK
from .stencil import (
    FaceFluxes,
    diffusion,
    flux_signs,
    quick_diag,
    quick_flux,
    upwind_diag,
    upwind_flux,
)

# Unified inner-loop stall policy (see sr_for_cfd_tpu/ops/sweeps.py for the
# measured failure modes that shaped it): a new margin-best resets the
# stall counter, a check that descends against the previous one holds it,
# anything else increments it; exit after STALL_PATIENCE increments, never
# before STALL_MIN_CHECKS checks.
STALL_PATIENCE = 2
STALL_MIN_CHECKS = 4
STALL_RATIO = 0.999
STALL_RESET_RATIO = 0.98


def np_scalar_type(dtype: torch.dtype):
    """The numpy scalar type whose arithmetic rounds like `dtype`."""
    return np.float64 if dtype == torch.float64 else np.float32


def stall_update(rms, prev, best, stale: int):
    """One policy step on numpy scalars of the working dtype. Returns
    (stale, best); `best` propagates NaN as `jnp.minimum` does."""
    t = type(rms)
    new_best = rms < t(STALL_RESET_RATIO) * best
    descending = rms < t(STALL_RATIO) * prev
    stale = 0 if new_best else (stale if descending else stale + 1)
    return stale, np.minimum(best, rms)


def stalled(stale: int, checks: int) -> bool:
    return stale >= STALL_PATIENCE and checks >= STALL_MIN_CHECKS


def optimal_sor(nx: int, ny: int) -> float:
    """Grid-optimal red-black SOR factor 2/(1 + sin(pi/N))."""
    return 2.0 / (1.0 + math.sin(math.pi / max(2, min(nx, ny))))


def checkerboard(nx: int, ny: int, device="cpu") -> torch.Tensor:
    """Red mask over the interior (even i+j, interior indices from 1)."""
    ii = torch.arange(1, nx + 1, device=device)[:, None]
    jj = torch.arange(1, ny + 1, device=device)[None, :]
    return (ii + jj) % 2 == 0


ResidualFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def momentum_residual(phi, phi_old_int, ff: FaceFluxes, scheme: str, dx, dy,
                      dt, nu, volp, signs):
    """R = -(volp/dt (phi - phi_old) + Fc - nu Fd)."""
    flux = quick_flux if scheme == QUICK else upwind_flux
    fd, _ = diffusion(phi, dx, dy, volp)
    c = phi[1:-1, 1:-1]
    return -(volp / dt * (c - phi_old_int) + flux(phi, ff, signs) - nu * fd)


def momentum_diag(ff: FaceFluxes, scheme: str, dx, dy, dt, nu, volp, signs):
    """ap = volp/dt + ap_c - nu ap_d; fixed while the fluxes are frozen."""
    diag = quick_diag if scheme == QUICK else upwind_diag
    ap_d = -volp * (2.0 / (dx * dx) + 2.0 / (dy * dy))
    return volp / dt + diag(ff, volp, signs) - nu * ap_d


def pressure_residual(p, rhs, dx, dy, volp):
    """R = rhs - Fd with rhs = rho/dt sum(Ff); ap = ap_d (< 0, a scalar:
    dividing by it rounds as dividing by the JAX package's array of it
    does)."""
    fd, ap_d = diffusion(p, dx, dy, volp)
    return rhs - fd, ap_d


def sweep_loop(
    phi: torch.Tensor,
    residual_fn: ResidualFn,
    nx: int,
    ny: int,
    tol: float,
    max_iter: int,
    inner_scheme: str = "redblack",
    check_every: int = 1,
    sor: float = 1.0,
) -> Tuple[torch.Tensor, int]:
    """Iterate point sweeps until RMS(R) < tol, a stall, or `max_iter`
    sweeps. Returns (field, sweeps_run)."""
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    n_cells = nx * ny
    red = checkerboard(nx, ny, phi.device)

    def sweep(f, with_rms):
        f = f.clone()
        if inner_scheme == "jacobi":
            r, ap = residual_fn(f)
            f[1:-1, 1:-1] += sor * r / ap
            if not with_rms:
                return f, None
            return f, torch.sqrt(torch.sum(r * r) / n_cells)
        r1, ap1 = residual_fn(f)
        f[1:-1, 1:-1] += torch.where(red, sor * r1 / ap1, 0.0)
        r2, ap2 = residual_fn(f)
        f[1:-1, 1:-1] += torch.where(red, 0.0, sor * r2 / ap2)
        if not with_rms:
            return f, None
        ss = torch.sum(torch.where(red, r1 * r1, r2 * r2))
        return f, torch.sqrt(ss / n_cells)

    t = np_scalar_type(phi.dtype)
    rms = best = t(np.inf)
    tol_t = t(tol)
    stale = checks = it = 0
    while it < max_iter and rms >= tol_t and not stalled(stale, checks):
        for _ in range(check_every - 1):
            phi, _ = sweep(phi, False)
        phi, rms_t = sweep(phi, True)
        new = t(rms_t.item())
        stale, best = stall_update(new, rms, best, stale)
        rms = new
        checks += 1
        it += check_every
    return phi, it


def solve_momentum(
    phi, phi_old_int, ff: FaceFluxes, *, scheme, dx, dy, dt, nu, volp,
    tol=1e-6, max_iter=1000, inner_scheme="redblack", check_every=1,
) -> Tuple[torch.Tensor, int]:
    """Implicit momentum solve for one velocity component; returns
    (field, sweeps_run)."""
    nx, ny = phi.shape[0] - 2, phi.shape[1] - 2
    signs = flux_signs(ff)
    ap = momentum_diag(ff, scheme, dx, dy, dt, nu, volp, signs)

    def fn(f):
        return momentum_residual(f, phi_old_int, ff, scheme, dx, dy, dt, nu,
                                 volp, signs), ap

    return sweep_loop(phi, fn, nx, ny, tol, max_iter, inner_scheme,
                      check_every)


def solve_pressure(
    p, ff: FaceFluxes, *, dx, dy, dt, rho, volp, tol=1e-6, max_iter=1000,
    inner_scheme="redblack", check_every=1, sor=1.0,
) -> Tuple[torch.Tensor, int]:
    """Pressure-Poisson solve with the face-flux divergence frozen as RHS;
    returns (field, sweeps_run)."""
    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    sor = min(sor, 1.0 if inner_scheme == "jacobi" else optimal_sor(nx, ny))
    rhs = rho / dt * ff.divergence_sum()

    def fn(f):
        return pressure_residual(f, rhs, dx, dy, volp)

    return sweep_loop(p, fn, nx, ny, tol, max_iter, inner_scheme,
                      check_every, sor)
