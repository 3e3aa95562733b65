"""Tiled red-black SOR pressure loop on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_tiled.py`).

`tiled_solve_pressure` is the port of the JAX function of the same name:
red-black SOR for volp * Laplacian(p) = rho/dt sum(Ff) with frozen ghosts,
omega clamped to `optimal_sor`, the update (sor r) / ap_d, the rms after
every sweep, the unified stall policy, and an exit on tolerance, stall or
`max_iter`. It returns (p, sweeps_run). Each sweep is one launch of
`csrc/shard_rb.cu`'s tiled red-black kernel on the whole padded grid (the
row-decomposed solver's per-rank kernel, launched on a one-rank block
with a one-row halo; the whole sweep and its residual partials in one
pass over device memory, out of place between two buffers), then
`srcfd_rms_finalize` over the partials and one host read; the exit is
decided on the host in numpy float32.

The JAX function's `slab_rows` and `check_every` are left out: neither
changes the result (the sweep is the same at every slab height, and the
exit is checked after every sweep whatever `check_every` says), the JAX
solver passes neither, and nothing in the port would set them.

On a CPU tensor the wrapper runs the plain PyTorch version,
`pressure_kernels.solve_pressure_plain(..., check_every=1, divide=True)`,
which computes exactly this function. On a CUDA tensor it launches the
kernel or raises. `tiled_solve_pressure.launches` counts kernel launches,
two per sweep (the sweep and the finalize).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import kernel_lib
from .pressure_kernels import _coefficients, solve_pressure_plain
from .stencil import FaceFluxes
from .sweeps import stall_update, stalled


def tiled_solve_pressure(
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
    sor: float = 1.0,
) -> Tuple[torch.Tensor, int]:
    """Red-black SOR pressure solve, one fused pass per sweep; returns
    (p, sweeps_run)."""
    if p.device.type == "cpu":
        return solve_pressure_plain(
            p, ff, dx=dx, dy=dy, dt=dt, rho=rho, volp=volp, tol=tol,
            max_iter=max_iter, check_every=1, sor=sor, divide=True)
    kernel_lib.check_field(p, "tiled red-black")
    nx2, ny2 = p.shape
    inv_dx2, inv_dy2, sor, _, ap_d = _coefficients(dx, dy, volp, sor,
                                                   nx2 - 2, ny2 - 2)
    b = torch.zeros_like(p)
    b[1:-1, 1:-1] = (rho / dt) * ff.divergence_sum()
    # two buffers with p's ghost ring; the kernel writes interiors only
    cur = p.clone(memory_format=torch.contiguous_format)
    nxt = cur.clone()
    lib = kernel_lib.load_library()
    stream = kernel_lib.stream_ptr(p.device)
    n_part = lib.srcfd_shard_rb_partials(nx2, ny2)
    partials = torch.empty(n_part, dtype=torch.float32, device=p.device)
    rms_dev = torch.empty(1, dtype=torch.float32, device=p.device)
    n_cells = float((nx2 - 2) * (ny2 - 2))

    t = np.float32
    rms = best = t(np.inf)
    tol32 = t(tol)
    stale = checks = it = 0
    while it < max_iter and rms >= tol32 and not stalled(stale, checks):
        kernel_lib.check(lib.srcfd_tiled_rb_sweep(
            cur.data_ptr(), nxt.data_ptr(), b.data_ptr(), partials.data_ptr(),
            nx2, ny2, inv_dx2, inv_dy2, volp, sor, ap_d, stream),
            "tiled_rb_sweep")
        kernel_lib.check(lib.srcfd_rms_finalize(
            partials.data_ptr(), n_part, n_cells, rms_dev.data_ptr(), stream),
            "rms_finalize")
        tiled_solve_pressure.launches += 2
        cur, nxt = nxt, cur
        now = t(rms_dev.item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        checks += 1
        it += 1
    return cur, it


tiled_solve_pressure.launches = 0
