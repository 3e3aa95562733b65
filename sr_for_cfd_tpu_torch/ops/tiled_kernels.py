"""Tiled red-black SOR pressure loop on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_tiled.py`).

`tiled_solve_pressure` is the port of the JAX function of the same name:
red-black SOR for volp * Laplacian(p) = rho/dt sum(Ff) with frozen ghosts,
omega clamped to `optimal_sor`, the update (sor r) / ap_d, the rms after
every sweep, the unified stall policy, and an exit on tolerance, stall or
`max_iter`. It returns (p, sweeps_run).

Each sweep is one launch of the fused form of `csrc/shard_rb.cu`'s tiled
red-black kernel on the whole padded grid (the row-decomposed solver's
per-rank kernel, on a one-rank block with a one-row halo, kb = 1): the
whole sweep and its residual sum in one pass, out of place between two
buffers. The exit is decided on the card: the launch's last block takes
the rms, runs the stall policy (as `rb_sor.cu`'s single-block loop does)
and sets `done` in a small device state (rms, best, stale, checks, it,
done); every block of a later launch returns at once when `done` is set.
So the host enqueues batches of BATCH launches (`_TiledLoop`, cached per
shape and setting, built by the solver's `precompile()`, on
`ops/exit_loop.py`'s `DeviceExitLoop`, which the momentum loops share) and
reads the state once per batch: ceil(sweeps / BATCH) reads, at most
ceil(max_iter / BATCH) batches. Each batch's state is copied to pinned host
memory behind it, and the next batch is enqueued before the host waits for
that copy, so the card does not idle while the host reads; a batch
enqueued after the exit runs as no-op launches. The result is the buffer
that sweep number `it` wrote. `exit_loop.exit_state_step` is the plain
twin of the last block's state update.

The JAX function's `slab_rows` and `check_every` are left out: neither
changes the result (the sweep is the same at every slab height, and the
exit is checked after every sweep whatever `check_every` says), the JAX
solver passes neither, and nothing in the port would set them.

On a CPU tensor the wrapper runs the plain PyTorch version,
`pressure_kernels.solve_pressure_plain(..., check_every=1, divide=True)`,
which computes exactly this function. On a CUDA tensor it launches the
kernel or raises. `tiled_solve_pressure.launches` counts kernel launches
(a batch after the exit adds its no-ops), `.sweeps` the sweeps run and
`.reads` the host reads of the loop state.
`_tiled_solve_pressure_host_exit` is the loop before the device-side exit
(the one-sweep kernel, `srcfd_rms_finalize` and a host read per sweep),
which only the card gates run, to hold the loop against it bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import kernel_lib, shard_rb
from .exit_loop import DeviceExitLoop, first_done
from .pressure_kernels import _coefficients, solve_pressure_plain
from .stencil import FaceFluxes
from .sweeps import (
    STALL_MIN_CHECKS,
    STALL_PATIENCE,
    STALL_RATIO,
    STALL_RESET_RATIO,
    stall_update,
    stalled,
)

# launches enqueued per host read of the loop state
BATCH = 8


class _TiledLoop(DeviceExitLoop):
    """The device-exit loop of one shape and setting: two field buffers
    with the ghost ring, the right-hand side, the kernel's partials, ticket
    and loop state, owned here as long as the parameter block that points
    at them; batches of BATCH launches, the next enqueued ahead. `_plan`
    overrides the fused kernel's plan (the card gates hold the other tile
    side against the default)."""

    def __init__(self, nx2: int, ny2: int, device, inv_dx2: float, inv_dy2: float,
                 volp: float, sor: float, ap_d: float, tol: float, max_iter: int,
                 *, _plan=None):
        super().__init__(device, tol, max_iter, counter=tiled_solve_pressure, batch=BATCH,
                         ahead=True)
        self.nx2, self.ny2 = nx2, ny2

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.bufs = [zeros((nx2, ny2)), zeros((nx2, ny2))]
        self.b = zeros((nx2, ny2))
        self.plan = _plan or shard_rb.shard_rb_plan(nx2, ny2, 1, 1)
        self.partials = zeros(self.plan.n_sum)
        self.ticket = zeros(1, torch.int32)
        self.params = shard_rb.make_params(
            self.plan, nx2, ny2, nxg=nx2 - 2, h=1, mode=1, inv_dx2=inv_dx2,
            inv_dy2=inv_dy2, volp=volp, sor=sor, inv_ap=1.0 / ap_d, ap_d=ap_d,
            partials=self.partials.data_ptr(), ticket=self.ticket.data_ptr(),
            state=self.state.data_ptr(), tol=tol, n_cells=float((nx2 - 2) * (ny2 - 2)),
            stall=(STALL_RESET_RATIO, STALL_RATIO, STALL_PATIENCE, STALL_MIN_CHECKS),
            max_iter=self.max_iter)
        self.addr = ctypes.addressof(self.params)

    def launch(self, i: int, stream: int) -> None:
        """Sweep number i + 1: bufs[i % 2] -> the own rows of bufs[(i + 1) % 2]."""
        src, dst = self.bufs[i % 2], self.bufs[(i + 1) % 2]
        kernel_lib.check(self.lib.srcfd_shard_rb_fused(
            self.addr, src.data_ptr(), dst.data_ptr() + 4 * self.ny2, self.b.data_ptr(),
            None, 0, stream), "tiled_rb_fused")

    def solve(self, p: torch.Tensor, rhs: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """Sweeps from p (its ghost ring frozen) for volp Lap(p) = rhs (the
        interior right-hand side); returns (p, sweeps_run)."""
        if first_done(self.tol32, self.max_iter):
            return p.clone(memory_format=torch.contiguous_format), 0
        self.bufs[0].copy_(p)
        # the kernel writes rows 1..nx
        self.bufs[1][0].copy_(p[0])
        self.bufs[1][-1].copy_(p[-1])
        self.b[1:-1, 1:-1].copy_(rhs)
        it = self.run(self.launch)
        tiled_solve_pressure.sweeps += it
        return self.bufs[it % 2].clone(), it


@functools.lru_cache(maxsize=4)
def cached_loop(nx2, ny2, device: str, inv_dx2, inv_dy2, volp, sor, ap_d, tol,
                max_iter) -> _TiledLoop:
    """The device-exit loop of one setting, built once: every solve with
    this setting reuses its buffers."""
    return _TiledLoop(nx2, ny2, device, inv_dx2, inv_dy2, volp, sor, ap_d, tol,
                      max_iter)


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
    loop = cached_loop(nx2, ny2, str(p.device), inv_dx2, inv_dy2, volp, sor, ap_d,
                       float(tol), int(max_iter))
    return loop.solve(p, (rho / dt) * ff.divergence_sum())


tiled_solve_pressure.launches = 0
tiled_solve_pressure.reads = 0
tiled_solve_pressure.sweeps = 0


def _tiled_solve_pressure_host_exit(
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
    """The loop before the device-side exit: per sweep one launch of the
    one-sweep kernel, `srcfd_rms_finalize` and a host read, the exit decided
    on the host in numpy float32 (two launches per sweep, counted in
    `_tiled_solve_pressure_host_exit.launches`). Card only; the gates hold
    `tiled_solve_pressure` against it."""
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
        _tiled_solve_pressure_host_exit.launches += 2
        cur, nxt = nxt, cur
        now = t(rms_dev.item())
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        checks += 1
        it += 1
    return cur, it


_tiled_solve_pressure_host_exit.launches = 0
