"""Red-black pressure solve with one halo exchange per half-sweep (counterpart of `sr_for_cfd_tpu/parallel/halo.py`).

Each rank of the group owns `rows = nx // n_ranks` interior rows; the
neighbouring rows travel by `mesh.ring_exchange` twice a sweep, the
residual sums are `mesh.psum`, and the boundary ranks substitute the frozen
ghost rows. Red-black parity is taken from global indices, so the iteration
is the single-device sweep's (`ops/sweeps.solve_pressure`) and the results
agree to the rounding of the sums. The plainest user of the ring layer;
`spmd_step.py` runs the solver's own pressure loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.stencil import FaceFluxes
from ..ops.sweeps import np_scalar_type, optimal_sor, stall_update, stalled
from .mesh import AXIS, all_gather, check_backend, psum, rank_of, ring_exchange, size_of


def shardmap_solve_pressure(
    p: torch.Tensor,
    ff: FaceFluxes,
    group=None,
    *,
    dx: float,
    dy: float,
    dt: float,
    rho: float,
    volp: float,
    tol: float = 1e-6,
    max_iter: int = 1000,
    sor: float = 1.0,
) -> torch.Tensor:
    """Red-black pressure solve over the ranks of `group`. Every rank
    passes the whole padded `p` and the whole face fluxes and gets the
    whole solved `p` back. Requires nx % n_ranks == 0."""
    check_backend(p.device, group)
    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    n_dev, rank = size_of(group), rank_of(group)
    if nx % n_dev != 0:
        raise ValueError(f"nx = {nx} must divide over {n_dev} '{AXIS}' devices")
    rows = nx // n_dev
    inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    ap_d = -volp * (2.0 * inv_dx2 + 2.0 * inv_dy2)
    n_cells = nx * ny
    sor = min(sor, optimal_sor(nx, ny))
    r0 = rank * rows

    b = ((rho / dt) * ff.divergence_sum())[r0:r0 + rows]
    x = p[1 + r0:1 + r0 + rows, 1:-1]
    ghost_w, ghost_e = p[0, 1:-1], p[-1, 1:-1]
    zero = p.new_zeros((1,))
    left_col = torch.cat([zero, p[1 + r0:1 + r0 + rows, 0], zero])[:, None]
    right_col = torch.cat([zero, p[1 + r0:1 + r0 + rows, -1], zero])[:, None]
    ii = torch.arange(rows, device=p.device)[:, None] + r0
    jj = torch.arange(ny, device=p.device)[None, :]
    red = (ii + jj) % 2 == 0

    def assemble(x):
        from_left, from_right = ring_exchange(x[-1:], x[:1], group)
        top = ghost_w[None] if rank == 0 else from_left
        bottom = ghost_e[None] if rank == n_dev - 1 else from_right
        xp = torch.cat([top, x, bottom], dim=0)
        return torch.cat([left_col, xp, right_col], dim=1)

    def residual(x):
        xp = assemble(x)
        c = xp[1:-1, 1:-1]
        fd = volp * ((xp[2:, 1:-1] - 2.0 * c + xp[:-2, 1:-1]) * inv_dx2
                     + (xp[1:-1, 2:] - 2.0 * c + xp[1:-1, :-2]) * inv_dy2)
        return b - fd

    t = np_scalar_type(p.dtype)
    rms = best = t(np.inf)
    tol_t = t(tol)
    stale = it = 0
    while it < max_iter and rms >= tol_t and not stalled(stale, it):
        r1 = residual(x)
        x = x + torch.where(red, sor * r1 / ap_d, 0.0)
        r2 = residual(x)
        x = x + torch.where(red, 0.0, sor * r2 / ap_d)
        ss = psum(torch.sum(torch.where(red, r1 * r1, r2 * r2)).reshape(1), group)
        now = t(np.sqrt(t(ss.item()) / t(n_cells)))
        # check_every == 1, so the sweep count doubles as the check count
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        it += 1
    out = p.clone()
    out[1:-1, 1:-1] = all_gather(x, group)
    return out
