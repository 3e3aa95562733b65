"""Red-black SOR pressure loop on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_kernels.py`).

`solve_pressure_kernel` is the port of `pallas_solve_pressure`: the same
red-black SOR for volp * Laplacian(p) = rho/dt sum(Ff) with frozen ghosts,
omega clamped to `optimal_sor`, rms every `check_every` sweeps, the unified
stall policy, and an exit on tolerance, stall or `max_iter`. It returns
(p, sweeps_run). The CUDA source is `csrc/rb_sor.cu`.

On a CPU tensor the wrapper runs the plain PyTorch version,
`solve_pressure_plain`: the same loop as `sweeps.solve_pressure`, with the
TPU kernel's arithmetic (multiply by the reciprocal diagonal and by
1/dx^2, 1/dy^2, where the jnp sweeps divide), so that near the float32
floor, where the stall policy decides, it takes the TPU kernel's exits.
`divide=True` updates with (sor r) / ap_d instead, as the point-iteration
pressure stage of the TPU's fused step does (`pallas_step.py:309`); the
fused step's staged design uses it.
On a CUDA tensor the wrapper launches the kernel or raises. Which kernel
is a routing by size of the padded (nx+2, ny+2) field (`route`):
- "warp": at most `WARP_MAX` rows and columns (the hybrid's 10x10 and
  20x20 coarse grids): one launch of a one-warp loop that builds its own
  right-hand side from the four face fluxes, so the call runs no other
  kernel; it keeps the "block" loop's bits (field, count, rms);
- "block": up to `srcfd_rb_small_max_cells()` cells: one launch of a
  single-block loop, b built and p copied here first;
- "two_launch": larger: a launch per half-sweep and one per check, the
  stall policy on the host.
`card_solve` is the wrapper past the CPU check; it also returns the last
rms. `solve_pressure_kernel.launches` counts kernel launches and
`solve_pressure_kernel.routes` the calls of each route that launched
(each at its first checked launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import kernel_lib
from .stencil import FaceFluxes
from .sweeps import (
    STALL_MIN_CHECKS,
    STALL_PATIENCE,
    STALL_RATIO,
    STALL_RESET_RATIO,
    checkerboard,
    np_scalar_type,
    optimal_sor,
    stall_update,
    stalled,
)


def _coefficients(dx, dy, volp, sor, nx, ny):
    sor = min(sor, optimal_sor(nx, ny))
    inv_dx2 = 1.0 / (dx * dx)
    inv_dy2 = 1.0 / (dy * dy)
    ap_d = -volp * (2.0 * inv_dx2 + 2.0 * inv_dy2)
    return inv_dx2, inv_dy2, sor, 1.0 / ap_d, ap_d


def rhs(ff: FaceFluxes, rho, dt) -> torch.Tensor:
    """b = rho/dt sum(Ff) on the interior, as every path of this module
    rounds it: ((e + n) + w) + s, times rho / dt rounded to their type."""
    return (rho / dt) * ff.divergence_sum()


def _padded_rhs(p: torch.Tensor, ff: FaceFluxes, rho, dt) -> torch.Tensor:
    b = torch.zeros_like(p)
    b[1:-1, 1:-1] = rhs(ff, rho, dt)
    return b


def solve_pressure_plain(
    p: torch.Tensor, ff: FaceFluxes, *, dx, dy, dt, rho, volp, tol=1e-6,
    max_iter=1000, check_every=8, sor=1.0, divide=False,
) -> Tuple[torch.Tensor, int]:
    """The kernel's loop in plain PyTorch; returns (p, sweeps_run)."""
    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    inv_dx2, inv_dy2, sor, inv_ap, ap_d = _coefficients(dx, dy, volp, sor,
                                                        nx, ny)
    b = rhs(ff, rho, dt)
    red = checkerboard(nx, ny, p.device)
    # a tensor, so that the card divides (by a Python scalar it multiplies
    # by the reciprocal)
    ap_d_t = torch.tensor(ap_d, dtype=p.dtype, device=p.device)

    def half(f, mask):
        c = f[1:-1, 1:-1]
        fd = volp * ((f[2:, 1:-1] - 2.0 * c + f[:-2, 1:-1]) * inv_dx2
                     + (f[1:-1, 2:] - 2.0 * c + f[1:-1, :-2]) * inv_dy2)
        r = b - fd
        f = f.clone()
        step = sor * r / ap_d_t if divide else sor * r * inv_ap
        f[1:-1, 1:-1] = c + torch.where(mask, step, 0.0)
        return f, r

    t = np_scalar_type(p.dtype)
    rms = best = t(np.inf)
    tol_t = t(tol)
    stale = checks = it = 0
    while it < max_iter and rms >= tol_t and not stalled(stale, checks):
        for s in range(check_every):
            p, r1 = half(p, red)
            p, r2 = half(p, ~red)
        ss = torch.sum(torch.where(red, r1 * r1, 0.0)
                       + torch.where(red, 0.0, r2 * r2))
        now = t(torch.sqrt(ss / (nx * ny)).item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        checks += 1
        it += check_every
    return p, it


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


WARP_MAX = 32  # padded rows and columns of the one-warp loop (rb_sor.cu RB_WARP_MAX)
ROUTES = ("warp", "block", "two_launch")
_I, _F = ctypes.c_int, ctypes.c_float


class Params(ctypes.Structure):
    """csrc/rb_sor.cu's RbWarpParams (the one-warp loop's settings), field
    for field."""

    _fields_ = [("nx2", _I), ("ny2", _I),
                *((n, _F) for n in ("inv_dx2", "inv_dy2", "volp", "sor", "inv_ap", "ap_d")),
                ("mode", _I), ("reset_ratio", _F), ("ratio", _F), ("patience", _I),
                ("min_checks", _I), ("rhodt", _F), ("tol", _F), ("max_iter", _I),
                ("check_every", _I)]


@functools.lru_cache(maxsize=64)
def _warp_params(nx2, ny2, dx, dy, volp, sor, rho, dt, tol, max_iter, check_every,
                 divide) -> Params:
    """The one-warp loop's settings for a call (ctypes rounds the floats to
    float32, rho / dt as the plain path's `rhs` does); cached, read only."""
    inv_dx2, inv_dy2, sor, inv_ap, ap_d = _coefficients(dx, dy, volp, sor,
                                                        nx2 - 2, ny2 - 2)
    return Params(nx2, ny2, inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d, int(divide),
                  STALL_RESET_RATIO, STALL_RATIO, STALL_PATIENCE, STALL_MIN_CHECKS,
                  rho / dt, tol, int(max_iter), int(check_every))


def route(nx2: int, ny2: int, small_max_cells: int) -> str:
    """The kernel that solves a padded (nx2, ny2) field (module docstring);
    `small_max_cells` is the library's `srcfd_rb_small_max_cells()`."""
    if nx2 <= WARP_MAX and ny2 <= WARP_MAX:
        return "warp"
    if nx2 * ny2 <= small_max_cells:
        return "block"
    return "two_launch"


def solve_pressure_kernel(
    p: torch.Tensor,
    ff: FaceFluxes,
    *,
    dx: float,
    dy: float,
    dt: float,
    rho: float,
    volp: float,
    tol: float = 1e-6,
    max_iter: int = 1000,
    check_every: int = 8,
    sor: float = 1.0,
    divide: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Red-black SOR pressure solve; returns (p, sweeps_run). `divide`
    selects the (sor r) / ap_d update (see the module docstring)."""
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    if p.device.type == "cpu":
        return solve_pressure_plain(
            p, ff, dx=dx, dy=dy, dt=dt, rho=rho, volp=volp, tol=tol,
            max_iter=max_iter, check_every=check_every, sor=sor,
            divide=divide)
    out, count, _ = card_solve(p, ff, dx=dx, dy=dy, dt=dt, rho=rho, volp=volp,
                               tol=tol, max_iter=max_iter, check_every=check_every,
                               sor=sor, divide=divide)
    return out, count


def card_solve(
    p: torch.Tensor, ff: FaceFluxes, *, dx, dy, dt, rho, volp, tol=1e-6,
    max_iter=1000, check_every=8, sor=1.0, divide=False, _kernel=None,
) -> Tuple[torch.Tensor, int, float]:
    """The wrapper on a tensor that is not on the CPU: the kernels of the
    route that p's size takes; returns (p, sweeps_run, the last check's
    rms). `_kernel` ("warp" or "block") is for the gates and card tests
    alone, which hold the two one-launch loops against each other on the
    same input whatever the size."""
    kernel_lib.check_field(p, "pressure")
    nx2, ny2 = p.shape
    lib = kernel_lib.load_library()
    if _kernel not in (None, "warp", "block"):
        raise ValueError(f"no one-launch kernel {_kernel!r}")
    kernel = _kernel or route(nx2, ny2, lib.srcfd_rb_small_max_cells())
    stream = kernel_lib.stream_ptr(p.device)
    if kernel == "warp":
        # the fluxes checked, p read, out and the count and rms's bits
        # (host memory the kernel writes, read after the stream's sync)
        # written: nothing else runs on the card
        prm = _warp_params(nx2, ny2, dx, dy, volp, sor, rho, dt, tol, max_iter,
                           check_every, divide)
        for t in ff:
            kernel_lib.check_field(t, "pressure", shape=(nx2 - 2, ny2 - 2))
        if any(t.get_device() != p.get_device() for t in ff):
            raise ValueError(f"the pressure kernel takes fluxes on {p.device}")
        out = torch.empty_like(p)
        state = torch.empty(2, dtype=torch.int32, pin_memory=True)
        kernel_lib.check(lib.srcfd_rb_sor_warp(
            ctypes.addressof(prm), _ptr(p), _ptr(out), *map(_ptr, ff), _ptr(state),
            stream), "rb_sor_warp")
        solve_pressure_kernel.launches += 1
        solve_pressure_kernel.routes["warp"] += 1
        kernel_lib.check(lib.srcfd_stream_sync(stream), "rb_sor_warp")
        count, rms = state.tolist()
        return out, count, float(np.int32(rms).view(np.float32))
    inv_dx2, inv_dy2, sor, inv_ap, ap_d = _coefficients(dx, dy, volp, sor,
                                                        nx2 - 2, ny2 - 2)
    coef = (inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d, int(divide))
    b = _padded_rhs(p, ff, rho, dt)
    out = p.clone(memory_format=torch.contiguous_format)
    if kernel == "block":
        # one block runs the whole loop, stall policy included
        state = torch.empty(2, dtype=torch.int32, device=p.device)
        kernel_lib.check(lib.srcfd_rb_sor_loop_small(
            _ptr(out), _ptr(b), nx2, ny2, *coef, STALL_RESET_RATIO, STALL_RATIO,
            STALL_PATIENCE, STALL_MIN_CHECKS, float(np.float32(tol)), int(max_iter),
            int(check_every), _ptr(state), _ptr(state) + 4, stream),
            "rb_sor_loop_small")
        solve_pressure_kernel.launches += 1
        solve_pressure_kernel.routes["block"] += 1
        count, rms = state.tolist()
        return out, count, float(np.int32(rms).view(np.float32))

    n_part = lib.srcfd_rb_partials(nx2, ny2)
    partials = torch.empty(2 * n_part, dtype=torch.float32, device=p.device)
    rms_dev = torch.empty(1, dtype=torch.float32, device=p.device)
    red_part = _ptr(partials)
    black_part = red_part + n_part * partials.element_size()
    n_cells = float((nx2 - 2) * (ny2 - 2))

    def half(color: int, part: int, with_rms: int) -> None:
        kernel_lib.check(lib.srcfd_rb_half_sweep(
            _ptr(out), _ptr(b), part, nx2, ny2, *coef, color, with_rms,
            stream), "rb_half_sweep")
        solve_pressure_kernel.launches += 1

    t = np.float32
    rms = best = t(np.inf)
    tol32 = t(tol)
    stale = checks = it = 0
    while it < max_iter and rms >= tol32 and not stalled(stale, checks):
        for s in range(check_every):
            last = int(s == check_every - 1)
            half(0, red_part, last)
            if it == s == 0:  # the call counted at its first launch
                solve_pressure_kernel.routes["two_launch"] += 1
            half(1, black_part, last)
        kernel_lib.check(lib.srcfd_rms_finalize(
            red_part, 2 * n_part, n_cells, _ptr(rms_dev), stream),
            "rms_finalize")
        solve_pressure_kernel.launches += 1
        now = t(rms_dev.item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        checks += 1
        it += check_every
    return out, it, float(rms)


solve_pressure_kernel.launches = 0
solve_pressure_kernel.routes = dict.fromkeys(ROUTES, 0)
