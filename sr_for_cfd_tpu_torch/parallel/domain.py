"""Domain decomposition of the solver grid over the padded rows (counterpart of `sr_for_cfd_tpu/parallel/domain.py`).

The JAX package shards the padded (nx+2, ny+2) fields along x with
`NamedSharding(P('x', None))` and jits the unchanged single-device program:
XLA's partitioner inserts the halo exchanges and the reductions. PyTorch
has no such partitioner, so `ShardedSolver` keeps the JAX split and runs
the explicit row-decomposed step of `spmd_step.py` on it:

* `grid_sharding` gives each rank (nx + 2) / n padded rows; the domain's
  ghost rows lie on the end ranks, which therefore own one interior row
  fewer than the middle ranks (nx = 30 over 4 ranks: 7, 8, 8, 7 rows);
* the step takes every rank's band (first interior row, rows), computes
  only its own, and plans its communication-avoiding blocks on the
  narrowest band, so every rank makes the same collectives;
* where the bands are unequal, the V-cycle (`spmd_mg.py`) smooths level 0
  on the bands (with `use_pallas` on the per-rank kernel, row 9, as
  `SpmdSolver` does), gathers its residual and runs the transfers and the
  coarser levels replicated, since no coarser level splits into the same
  unequal bands. Where they are equal (one rank, or nx + 2 = 2 (nx / 2 +
  1) over two), it is `SpmdSolver`'s step bit for bit.

Counts equal the single-device solver's and the fields agree to the
rounding of the summed residuals (float64: within 1e-12 of the JAX
package's `ShardedSolver`, `tests/test_torch_domain.py`). Settings the
explicit step cannot decompose are refused, not run on a replicated whole
grid: `fused_step=True` (the whole-step kernel holds the whole grid) and
any `pressure_solver` other than 'sweeps' or 'multigrid'.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import CaseConfig
from ..ops.bc import apply_bc, apply_bfs_inlet
from ..ops.stencil import FaceFluxes
from ..solver.state import SolverState
from .mesh import Mesh, Sharding, grid_sharding
from .spmd_step import SpmdSolver, SpmdState, local_band


def padded_bands(sharding: Sharding, nx: int):
    """Every rank's (first interior row, rows): the interior rows of its
    block of the (nx + 2) padded rows under `sharding`."""
    out = []
    for block in sharding.blocks(nx + 2):
        lo, hi = max(block.start, 1), min(block.stop, nx + 1)
        out.append((lo - 1, hi - lo))
    return tuple(out)


def _check_divides(case: CaseConfig, n_shards: int) -> None:
    if (case.mesh.nx + 2) % n_shards != 0:
        raise ValueError(
            f"nx+2 = {case.mesh.nx + 2} must divide evenly over "
            f"{n_shards} devices for the GSPMD x-axis decomposition "
            f"(NamedSharding requires divisibility). For reference "
            f"grid sizes (400/512/1024/2048, where nx but not nx+2 "
            f"divides), use parallel.spmd_step.SpmdSolver - the "
            f"explicit shard_map path over interior rows."
        )


def shard_state(state: SolverState, mesh: Mesh, axis: str = "x") -> SpmdState:
    """This rank's share of a whole `SolverState` under `grid_sharding`:
    the interior rows of its padded block."""
    bands = padded_bands(grid_sharding(mesh, axis), state.u.shape[0] - 2)
    return local_band(state, *bands[mesh.coords()[axis]])


class ShardedSolver(SpmdSolver):
    """Domain-decomposed solver over the padded-row split of `mesh`'s
    `axis`: the `run_chunk` / `solve` surface of the JAX package's
    `ShardedSolver`, each rank stepping its band. Every rank constructs it
    and calls its methods in the same order (they hold collectives).
    `state` gathers the whole `SolverState`; `local` is this rank's band.
    `device` defaults to the card (an NCCL group); `device="cpu"` with a
    gloo group runs the plain path."""

    def __init__(self, case: CaseConfig, mesh: Mesh, axis: str = "x", device="cuda"):
        self.sharding = grid_sharding(mesh, axis)
        _check_divides(case, mesh.shape[axis])
        st = case.settings
        if st.fused_step:
            raise ValueError(
                "ShardedSolver decomposes the step row by row; fused_step=True "
                "(the whole-step kernel over the whole grid) does not "
                "decompose: use fused_step=False (use_pallas=True runs the "
                "per-rank pressure sweep kernel)")
        if st.pressure_solver not in ("sweeps", "multigrid"):
            raise ValueError(
                "ShardedSolver decomposes pressure_solver='sweeps' or "
                f"'multigrid'; pressure_solver={st.pressure_solver!r} does not "
                "decompose row by row")
        self.mesh = mesh
        super().__init__(case, mesh.axis_group(axis), device)

    def _split(self, case: CaseConfig, n_dev: int):
        bands = padded_bands(self.sharding, case.mesh.nx)
        if len(bands) != n_dev:
            raise ValueError(f"the mesh's {self.sharding.axis_name!r} axis has "
                             f"{len(bands)} ranks, its process group {n_dev}")
        return bands

    @property
    def state(self) -> SolverState:
        """The whole state, gathered from every rank's band (a collective):
        the padded fields with the ghost ring derived again, as the
        single-device solver holds them."""
        s, c = self.local, self.case
        nx, ny = c.mesh.nx, c.mesh.ny
        w = ny + 2
        padded = self._gather(torch.cat([s.u, s.v, s.p, s.cau_u, s.cau_v], dim=1))
        inner = self._gather(torch.cat([s.u_old, s.v_old, s.p_old, *s.ff], dim=1))

        def whole(i, k, bc):
            full = padded.new_zeros((nx + 2, w))
            full[1:-1] = padded[:, i * w:(i + 1) * w]
            return apply_bfs_inlet(apply_bc(full, bc), k, self.profile)

        u, v, p = (whole(i, k, bc) for i, k, bc in ((0, 0, c.u_bc), (1, 1, c.v_bc),
                                                     (2, 2, c.p_bc)))
        parts = [inner[:, i * ny:(i + 1) * ny] for i in range(7)]
        return SolverState(
            u=u, v=v, p=p, u_old=parts[0], v_old=parts[1], p_old=parts[2],
            ff=FaceFluxes(*parts[3:]), rms=s.rms.copy(), count=s.count,
            converged=s.converged, diverged=s.diverged, held=s.held,
            plat_best=s.plat_best.copy(), plat_acc=s.plat_acc.copy(), plat_n=s.plat_n,
            plat_stale=s.plat_stale, cau_u_ref=whole(3, 0, c.u_bc),
            cau_v_ref=whole(4, 1, c.v_bc), cau_count=s.cau_count)

    def run_chunk(self) -> SolverState:
        """`chunk_size` steps (fewer when the state is done); the whole
        state gathered."""
        super().run_chunk()
        return self.state

    def solve(self, max_chunks: Optional[int] = None) -> SolverState:
        """Chunks until converged, diverged or `max_iterations`, or
        `max_chunks` chunks: the JAX `ShardedSolver`'s stop rule (without
        `SpmdSolver.solve`'s host plateau window). Each chunk's end joins
        `residual_history`."""
        chunks = 0
        while True:
            SpmdSolver.run_chunk(self)
            chunks += 1
            s = self.local
            self.residual_history.append(s.count, s.rms)
            done = s.converged or s.diverged or s.count >= self.case.settings.max_iterations
            if done or (max_chunks is not None and chunks >= max_chunks):
                return self.state
