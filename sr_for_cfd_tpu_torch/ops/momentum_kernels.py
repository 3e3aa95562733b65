"""Red-black momentum loop for grids of any size on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_momentum.py`).

`tiled_solve_momentum` is the port of the TPU's `tiled_solve_momentum`
(`pallas_momentum.py:222`): `check_every` whole red-black sweeps per pass
(the TPU runs them in one pass over HBM), the rms of the pass's last sweep,
and the unified stall policy counted in passes. The loop exits as the TPU
loop does: `it < max_iter and rms >= tol and not stalled(stale, passes)`,
with `it` advancing by `check_every`, so the sweep count is a multiple of
it.

On the card each pass is one launch of the fused momentum pass
(`csrc/mom_pass.cu`, host side `ops/mom_pass.py`): the k sweeps and the
last sweep's residual sum from shared memory, the exit decided by the
launch's last block in a device state (`ops/exit_loop.py`). The host
enqueues one pass and reads the state behind it (BATCH = 1, not ahead):
97% of the 2048^2 big-grid cavity's solves run one pass (PERF.md), so a
larger batch would add a no-op launch to nearly every solve to save a read
in a few. A k past the fused pass's shared memory (`mom_pass.fits`) runs
on the staged form (`_solve_host_exit`: one `csrc/tiled_momentum.cu`
launch per half-sweep, `srcfd_rms_finalize` and a host read per pass),
which the card gates also hold the fused loop against, bit for bit.

The slab height does not change what the port computes (the H100 has no
VMEM wall, so the kernel has no slabs), but it decides which settings the
TPU package accepts: its halo of 3 rows per sweep (2 for UPWIND) must fit
the slab, whose height `resolve_slab_rows` caps by width. The wrapper
computes the same height and raises the same `ValueError`s, so that both
packages accept the same configurations.

`tiled_solve_momentum_plain` is the plain PyTorch version, with the TPU
kernel's arithmetic: Laplacian times 1/dx^2 and 1/dy^2, the update r / ap,
QUICK's +-2 neighbours clamped at the first and last interior lines. On a
CPU tensor the wrapper runs it; on a CUDA tensor it launches the kernel or
raises. `tiled_solve_momentum.launches` counts kernel launches (no-op ones
included), `.reads` host reads of the loop's rms or state, `.sweeps` the
sweeps run on the card.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..config import QUICK
from . import kernel_lib, mom_pass
from .mg_kernels import launch
from .stencil import (
    FaceFluxes,
    flux_signs,
    quick_diag,
    quick_flux,
    shifts1,
    upwind_diag,
    upwind_flux,
)
from .sweeps import stall_update, stalled, sweep_loop


def resolve_slab_rows(slab_rows: int, W: int) -> int:
    """The TPU kernel's slab height at padded width W: halved while a slab
    exceeds 1 MiB of float32 (a TPU compile limit of its six streamed
    windows), not below 8 rows."""
    R = slab_rows
    while R > 8 and R * W * 4 > (1 << 20):
        R //= 2
    return R


def check_halo(slab_rows: int, W: int, scheme: str, check_every: int) -> int:
    """Raise as the TPU kernel does when its halo (3 rows per sweep for
    QUICK, 2 for UPWIND, `check_every` sweeps per pass) exceeds the slab;
    returns the sweeps per pass."""
    R = resolve_slab_rows(slab_rows, W)
    k_sweeps = max(1, check_every)
    H = (3 if scheme == QUICK else 2) * k_sweeps
    if R < H:
        if R < slab_rows:
            raise ValueError(
                f"slab_rows auto-shrunk to {R} at width {W} (compile-"
                f"budget cap), below the {H}-row halo ({k_sweeps} "
                f"sweeps/pass) - lower check_every (raising slab_rows "
                f"cannot help at this width)")
        raise ValueError(
            f"slab_rows={R} smaller than the {H}-row halo "
            f"({k_sweeps} sweeps/pass) - raise slab_rows or lower "
            "check_every")
    return k_sweeps


def _coefficients(dx, dy, volp):
    inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    return inv_dx2, inv_dy2, -volp * (2.0 * inv_dx2 + 2.0 * inv_dy2)


def momentum_residual_fn(phi_old_int: torch.Tensor, ff: FaceFluxes, *, scheme: str,
                         dx: float, dy: float, dt: float, nu, volp: float):
    """The kernel's residual in plain PyTorch: f -> (r, ap) on the interior
    of a padded field f."""
    inv_dx2, inv_dy2, ap_d = _coefficients(dx, dy, volp)
    nu = torch.as_tensor(nu, dtype=phi_old_int.dtype, device=phi_old_int.device)
    quick = scheme == QUICK
    signs = flux_signs(ff)
    flux = quick_flux if quick else upwind_flux
    ap = volp / dt + (quick_diag if quick else upwind_diag)(ff, volp, signs) - nu * ap_d

    def residual(f):
        c, e, w, n, s = shifts1(f)
        fd = volp * ((e - 2.0 * c + w) * inv_dx2 + (n - 2.0 * c + s) * inv_dy2)
        return -(volp / dt * (c - phi_old_int) + flux(f, ff, signs) - nu * fd), ap

    return residual


def tiled_solve_momentum_plain(
    phi: torch.Tensor, phi_old_int: torch.Tensor, ff: FaceFluxes, *,
    scheme: str, dx: float, dy: float, dt: float, nu, volp: float,
    tol: float = 1e-6, max_iter: int = 1000, check_every: int = 1,
) -> Tuple[torch.Tensor, int]:
    """The kernel's loop in plain PyTorch; returns (phi, sweeps_run)."""
    nx, ny = phi.shape[0] - 2, phi.shape[1] - 2
    residual = momentum_residual_fn(phi_old_int, ff, scheme=scheme, dx=dx, dy=dy,
                                    dt=dt, nu=nu, volp=volp)
    return sweep_loop(phi, residual, nx, ny, tol, max_iter,
                      check_every=max(1, check_every))


# passes enqueued per host read of the loop state (not ahead)
BATCH = 1


def _solve_on_card(phi, old, ff, quick, dx, dy, dt, nu, volp, tol, max_iter,
                   k_sweeps):
    if not mom_pass.fits(k_sweeps, quick):
        return _solve_host_exit(phi, old, ff, quick, dx, dy, dt, nu, volp, tol,
                                max_iter, k_sweeps)
    nx2, ny2 = phi.shape
    inv_dx2, inv_dy2, ap_d = _coefficients(dx, dy, volp)
    coef = mom_pass.Coef(volp, volp / dt, inv_dx2, inv_dy2, ap_d)
    loop = mom_pass.cached_loop(nx2, ny2, str(phi.device), bool(quick), k_sweeps, False,
                                coef, float(tol), int(max_iter), False, BATCH, False,
                                tiled_solve_momentum)
    out, it = loop.solve(phi, old, ff, nu)
    tiled_solve_momentum.sweeps += it
    return (out if it else phi.clone()), it


def _solve_host_exit(phi, old, ff, quick, dx, dy, dt, nu, volp, tol, max_iter,
                     k_sweeps):
    """The staged form: per pass 2k half-sweep launches, a finalize and a
    host read, the exit decided on the host in numpy float32."""
    lib = kernel_lib.load_library()
    stream = kernel_lib.stream_ptr(phi.device)
    count = tiled_solve_momentum
    nx2, ny2 = phi.shape
    inv_dx2, inv_dy2, ap_d = _coefficients(dx, dy, volp)
    coef = (nx2, ny2, int(quick), volp, volp / dt, inv_dx2, inv_dy2, ap_d)
    f, g = phi.clone(), torch.empty_like(phi)
    n_part = lib.srcfd_step_mom_partials(nx2, ny2)  # the half-sweep's grid
    partials = torch.empty(2 * n_part, dtype=torch.float32, device=phi.device)
    rms_dev = torch.empty(1, dtype=torch.float32, device=phi.device)
    red = partials.data_ptr()
    black = red + n_part * partials.element_size()
    n_cells = float((nx2 - 2) * (ny2 - 2))
    args = (old.data_ptr(), *(t.data_ptr() for t in ff), nu.data_ptr())

    t = np.float32
    rms = best = t(np.inf)
    tol32 = t(tol)
    stale = checks = it = 0
    while it < max_iter and rms >= tol32 and not stalled(stale, checks):
        for s in range(k_sweeps):
            last = s == k_sweeps - 1
            launch(count, lib.srcfd_tm_half(
                f.data_ptr(), g.data_ptr(), *args, *coef, 0,
                red if last else None, stream), "tm_half")
            launch(count, lib.srcfd_tm_half(
                g.data_ptr(), f.data_ptr(), *args, *coef, 1,
                black if last else None, stream), "tm_half")
        launch(count, lib.srcfd_rms_finalize(
            red, 2 * n_part, n_cells, rms_dev.data_ptr(), stream),
            "rms_finalize")
        count.reads += 1
        now = t(rms_dev.item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        checks += 1
        it += k_sweeps
    count.sweeps += it
    return f, it


def tiled_solve_momentum(
    phi: torch.Tensor,
    phi_old_int: torch.Tensor,
    ff: FaceFluxes,
    *,
    scheme: str,
    dx: float,
    dy: float,
    dt: float,
    nu,
    volp: float,
    tol: float = 1e-6,
    max_iter: int = 1000,
    check_every: int = 1,
    slab_rows: int = 256,
    return_count: bool = False,
    _staged: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Red-black momentum solve (float32) with the TPU kernel's residual,
    check cadence and stall policy. With `return_count`, returns
    (phi, sweeps_run). `_staged` runs the staged form on the card (the
    gates hold the fused loop against it)."""
    if phi.dtype != torch.float32:
        raise ValueError("tiled_solve_momentum is float32-only")
    k_sweeps = check_halo(slab_rows, phi.shape[1], scheme, check_every)
    if phi.device.type == "cpu":
        out, it = tiled_solve_momentum_plain(
            phi, phi_old_int, ff, scheme=scheme, dx=dx, dy=dy, dt=dt, nu=nu,
            volp=volp, tol=tol, max_iter=max_iter, check_every=k_sweeps)
    else:
        kernel_lib.check_field(phi, "tiled momentum")
        old = phi_old_int.to(torch.float32).contiguous()
        ff = FaceFluxes(*(t.to(torch.float32).contiguous() for t in ff))
        if any(t.device != phi.device for t in (old, *ff)):
            raise ValueError("the tiled momentum kernel takes the old field "
                             "and the face fluxes on the field's device")
        nu_dev = torch.as_tensor(nu, dtype=torch.float32,
                                 device=phi.device).reshape(1).contiguous()
        solve = _solve_host_exit if _staged else _solve_on_card
        out, it = solve(phi, old, ff, scheme == QUICK, dx, dy, dt, nu_dev, volp, tol,
                        max_iter, k_sweeps)
    return (out, it) if return_count else out


tiled_solve_momentum.launches = 0
tiled_solve_momentum.reads = 0
tiled_solve_momentum.sweeps = 0
