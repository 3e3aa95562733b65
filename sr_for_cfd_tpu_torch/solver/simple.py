"""SIMPLE outer iteration, host loop and solver facade (counterpart of `sr_for_cfd_tpu/solver/simple.py`).

`simple_step` is the JAX package's non-fused step: momentum u, v (inner
sweeps) -> under-relax -> BCs -> face fluxes -> pressure -> under-relax ->
BC -> projection (+ residuals) -> u, v BCs -> Rhie-Chow -> RMS check.
With `use_pallas` the pressure solve runs on the hand-written CUDA kernels
(`ops/pressure_kernels.py` for 'sweeps', `ops/mg_kernels.py` for
'multigrid'); momentum, fluxes, BCs and projection are plain PyTorch, as
they are `jnp` outside any Pallas kernel in the JAX package. Past the
big-grid threshold, or with `mg_slab_rows > 0` (`config.big_grid_kernels`,
the JAX package's `big_grid_pallas`), both halves of the step take the
big-grid kernels: the momentum solves `ops/momentum_kernels.py` (with
`momentum_check_every` raised to at least 3, announced by `CFDSolver`) and
the multigrid pressure `ops/stream_kernels.py`. `pressure_solver='tiled'`
takes the one-pass tiled sweep kernel (`ops/tiled_kernels.py`) for the
pressure, the momentum solves staying the plain sweeps, as in the JAX
package. With `fused_step` the whole step, `steps_per_kernel` of them per
call, runs through `ops/step_kernels.py` (`_fused_step`).

The JAX package runs chunks of outer steps inside one `lax.while_loop`.
Here the host runs each step and reads its three residuals; `run_chunk`
applies the same RRE jumps and detectors in the same order (RRE,
sustained hold, field Cauchy, plateau window), with numpy scalars of the
working dtype, so the exit decisions and iteration counts are the JAX
package's. `CFDSolver.solve`
adds the per-chunk host checks (history, divergence, host plateau).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import (
    BFSGeometry,
    BoundaryConditions,
    CaseConfig,
    FluidProperties,
    MeshParameters,
    SolverSettings,
    big_grid_kernels,
)
from ..ops import extrapolate as rre
from ..ops.bc import BFSInletProfile, apply_bc, apply_bfs_inlet
from ..ops.stencil import (
    face_fluxes,
    project_velocity,
    residual_sumsq,
    rhie_chow_update,
    under_relax,
)
from ..ops.sweeps import solve_momentum, solve_pressure
from ..utils.device import resolve_device
from ..utils.timing import profile_trace
from .state import SolverState, init_state, inlet_profile, torch_dtype, warm_start_state


def _tiled_momentum(case: CaseConfig) -> bool:
    """The big-grid path's momentum solves take the tiled kernel (red-black,
    float32), as in the JAX package."""
    st = case.settings
    return (big_grid_kernels(st, case.mesh) and st.inner_scheme == "redblack"
            and st.dtype == "float32")


def _big_grid_notices(case: CaseConfig) -> None:
    """Print what the big-grid path changes, as the JAX package prints it
    when it compiles the step: the raised momentum_check_every and a slab
    height clamped to the TPU's slab envelope."""
    st = case.settings
    if _tiled_momentum(case) and st.momentum_check_every < 3:
        print(f"[tiled-momentum] momentum_check_every "
              f"{st.momentum_check_every} -> 3 (multi-sweep kernel "
              "passes; inner counts become multiples of 3)")
    if big_grid_kernels(st, case.mesh) and st.pressure_solver == "multigrid":
        from ..ops.stream_kernels import SLAB_ROWS, auto_slab_rows

        rows, ny = st.mg_slab_rows or SLAB_ROWS, case.mesh.ny
        if auto_slab_rows(rows, ny) != rows:
            print(f"[stream-mg] slab_rows {rows} -> {auto_slab_rows(rows, ny)} "
                  f"at width {ny} (VMEM slab envelope; see "
                  "stream_kernels.SLAB_CELLS_MAX)", flush=True)


def _momentum_solver(case: CaseConfig):
    """(f, f_old_int, ff, nu) -> (f, sweeps): the tiled momentum kernel on
    the big-grid path, else the plain sweeps."""
    mesh, st = case.mesh, case.settings
    kw = dict(scheme=st.scheme, dx=mesh.dx, dy=mesh.dy, dt=st.dt,
              volp=mesh.volp, tol=st.inner_tolerance, max_iter=st.inner_max_iter)
    if _tiled_momentum(case):
        from ..ops import momentum_kernels
        from ..ops.stream_kernels import SLAB_ROWS, auto_slab_rows

        # at least 3 sweeps per pass, as the JAX package does
        check_every = max(3, st.momentum_check_every)
        slab_rows = auto_slab_rows(st.mg_slab_rows or SLAB_ROWS, mesh.ny + 2)
        return lambda f, old, ff, nu: momentum_kernels.tiled_solve_momentum(
            f, old, ff, nu=nu, check_every=check_every, slab_rows=slab_rows,
            return_count=True, **kw)
    return lambda f, old, ff, nu: solve_momentum(
        f, old, ff, nu=nu, inner_scheme=st.inner_scheme,
        check_every=st.momentum_check_every, **kw)


def _pressure(p, ff, case: CaseConfig) -> Tuple[torch.Tensor, int]:
    mesh, fluid, st = case.mesh, case.fluid, case.settings
    kw = dict(dx=mesh.dx, dy=mesh.dy, dt=st.dt, rho=fluid.rho, volp=mesh.volp,
              tol=st.inner_tolerance)
    if st.pressure_solver == "multigrid":
        mg_kw = dict(n_pre=st.mg_n_pre, n_post=st.mg_n_post,
                     smoother_sor=st.mg_smoother_sor, min_size=st.mg_min_size,
                     coarsest_sweeps=st.mg_coarsest_sweeps)
        if big_grid_kernels(st, mesh):
            from ..ops import stream_kernels

            return stream_kernels.stream_mg_solve_pressure(
                p, ff, **kw, **mg_kw, return_count=True,
                slab_rows=st.mg_slab_rows or stream_kernels.SLAB_ROWS)
        if st.use_pallas:
            from ..ops.mg_kernels import mg_solve_pressure_kernel

            return mg_solve_pressure_kernel(p, ff, **kw, **mg_kw)
        from ..ops.multigrid import mg_solve_pressure

        return mg_solve_pressure(p, ff, **kw, **mg_kw)
    if st.pressure_solver == "tiled":  # config guarantees f32, no use_pallas
        from ..ops.tiled_kernels import tiled_solve_pressure

        return tiled_solve_pressure(p, ff, **kw, max_iter=st.inner_max_iter,
                                    sor=st.pressure_sor)
    if st.use_pallas:  # config guarantees f32 + 'sweeps'
        from ..ops.pressure_kernels import solve_pressure_kernel

        return solve_pressure_kernel(
            p, ff, **kw, max_iter=st.inner_max_iter,
            check_every=st.pressure_check_every, sor=st.pressure_sor)
    return solve_pressure(
        p, ff, **kw, max_iter=st.inner_max_iter, inner_scheme=st.inner_scheme,
        check_every=st.pressure_check_every, sor=st.pressure_sor)


def simple_step(
    state: SolverState,
    case: CaseConfig,
    profile: Optional[BFSInletProfile],
    nu=None,
    with_counts: bool = False,
):
    """One SIMPLE outer iteration. `nu` overrides the viscosity (a 0-d
    tensor of the working dtype, so `nu * x` rounds as in the JAX step).
    With `with_counts`, also returns {'u', 'v', 'p'} inner sweep (or
    V-cycle) counts."""
    mesh, fluid, st = case.mesh, case.fluid, case.settings
    if nu is None:
        nu = torch.tensor(fluid.nu, dtype=state.u.dtype, device=state.u.device)
    if st.spmd_devices > 1:
        raise ValueError(
            f"case declares spmd_devices={st.spmd_devices}: run it "
            "through parallel.spmd_step.SpmdSolver on a matching mesh, "
            "not the single-device solver"
        )
    if st.fused_step:
        return _fused_step(state, case, profile, nu, with_counts=with_counts)
    dx, dy, dt = mesh.dx, mesh.dy, st.dt
    # both dispatch sites (momentum, pressure) route by big_grid_kernels, as
    # the JAX package routes both by its one big_grid_pallas flag
    momentum = _momentum_solver(case)
    counts = {}

    u, counts["u"] = momentum(state.u, state.u_old, state.ff, nu)
    u = under_relax(u, state.u_old, st.relax("u"))
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)

    v, counts["v"] = momentum(state.v, state.v_old, state.ff, nu)
    v = under_relax(v, state.v_old, st.relax("v"))
    v = apply_bfs_inlet(apply_bc(v, case.v_bc), 1, profile)

    ff = face_fluxes(u, v, dx, dy)
    p, counts["p"] = _pressure(state.p, ff, case)
    p = under_relax(p, state.p_old, st.relax("p"))
    p = apply_bc(p, case.p_bc)

    u, v = project_velocity(u, v, p, dt, fluid.rho, dx, dy)
    res = torch.stack([
        residual_sumsq(u, state.u_old),
        residual_sumsq(v, state.v_old),
        residual_sumsq(p, state.p_old),
    ])
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)
    v = apply_bfs_inlet(apply_bc(v, case.v_bc), 1, profile)
    ff = rhie_chow_update(ff, p, dt, fluid.rho, dx, dy)

    rms = (torch.sqrt(res / (mesh.nx * mesh.ny)) / dt).cpu().numpy()
    crit = np.asarray([st.criterion("u"), st.criterion("v"),
                       st.criterion("p")], dtype=rms.dtype)
    new_state = state.replace(
        u=u, v=v, p=p,
        u_old=u[1:-1, 1:-1], v_old=v[1:-1, 1:-1], p_old=p[1:-1, 1:-1],
        ff=ff, rms=rms, count=state.count + 1,
        converged=bool(np.all(rms <= crit)),
        diverged=not bool(np.all(np.isfinite(rms))),
    )
    if with_counts:
        return new_state, counts
    return new_state


def _fused_step(state: SolverState, case: CaseConfig,
                profile: Optional[BFSInletProfile], nu, with_counts: bool = False):
    """`steps_per_kernel` outer steps through the whole-step kernel; rms
    from the last step's residual sums, counts summed over the steps."""
    from ..ops.step_kernels import simple_step_kernel

    st = case.settings
    u, v, p, ff, res, cnt = simple_step_kernel(
        state.u, state.v, state.p, state.ff, case, profile, nu=nu)
    rms = (torch.sqrt(res / (case.mesh.nx * case.mesh.ny)) / st.dt).cpu().numpy()
    crit = np.asarray([st.criterion("u"), st.criterion("v"),
                       st.criterion("p")], dtype=rms.dtype)
    new_state = state.replace(
        u=u, v=v, p=p,
        u_old=u[1:-1, 1:-1], v_old=v[1:-1, 1:-1], p_old=p[1:-1, 1:-1],
        ff=ff, rms=rms, count=state.count + st.steps_per_kernel,
        converged=bool(np.all(rms <= crit)),
        diverged=not bool(np.all(np.isfinite(rms))),
    )
    if with_counts:
        return new_state, dict(zip("uvp", cnt))
    return new_state


def _active(state: SolverState, max_iterations: int) -> bool:
    return (not state.converged and not state.diverged
            and state.count < max_iterations)


def apply_detectors(s: SolverState, st: SolverSettings) -> SolverState:
    """The device-side detectors of the JAX chunk loop, in its order:
    sustained hold, field-Cauchy drift, plateau window."""
    if st.convergence_hold > 1:
        held = s.held + 1 if s.converged else 0
        s = s.replace(converged=held >= st.convergence_hold, held=held)
    if st.cauchy_tol > 0.0:
        at_check = s.count % st.cauchy_check_every == 0
        full = (s.count - s.cau_count) >= st.cauchy_check_every
        steady = False
        if at_check and full:
            du = torch.max(torch.abs(s.u - s.cau_u_ref))
            dv = torch.max(torch.abs(s.v - s.cau_v_ref))
            steady = bool((du < st.cauchy_tol) & (dv < st.cauchy_tol))
        if at_check:
            s = s.replace(cau_u_ref=s.u, cau_v_ref=s.v, cau_count=s.count)
        s = s.replace(converged=s.converged or steady)
    if st.plateau_patience > 0:
        t = s.rms.dtype.type
        acc = s.plat_acc + s.rms
        wn = s.plat_n + 1
        at_check = s.count % st.plateau_check_every == 0
        mean = acc / t(max(wn, 1))
        improved = bool(np.any(mean < t(1.0 - st.plateau_rtol) * s.plat_best))
        stale = ((0 if improved else s.plat_stale + 1) if at_check
                 else s.plat_stale)
        s = s.replace(
            plat_best=np.minimum(s.plat_best, mean) if at_check else s.plat_best,
            plat_acc=np.zeros_like(acc) if at_check else acc,
            plat_n=0 if at_check else wn,
            plat_stale=stale,
            converged=s.converged or stale >= st.plateau_patience,
        )
    return s


def _rre_update(s: SolverState, buf, case: CaseConfig,
                profile: Optional[BFSInletProfile]):
    """Push a snapshot when the count is on the RRE cadence; once the
    buffer holds rre_depth+1 snapshots, jump (if the extrapolation is
    plausible) and restart the buffer."""
    st = case.settings
    if s.count % st.rre_every == 0 and s.count >= st.rre_min_count:
        buf = rre.push_snapshot(buf, rre.flatten_state(s.u, s.v, s.p, s.ff))
    if buf.count > st.rre_depth:
        x_star, ok = rre.rre_extrapolate(buf.snaps)
        if ok:
            u, v, p, ff = rre.inject_state(x_star, case, profile)
            s = s.replace(u=u, v=v, p=p, u_old=u[1:-1, 1:-1],
                          v_old=v[1:-1, 1:-1], p_old=p[1:-1, 1:-1], ff=ff)
        buf = buf._replace(count=0)
    return s, buf


def run_chunk(state: SolverState, profile: Optional[BFSInletProfile],
              case: CaseConfig, n_steps: int, nu=None) -> SolverState:
    """Up to `n_steps` outer iterations; stops early on convergence,
    divergence or max_iterations. With `fused_step`, each call of the step
    runs `steps_per_kernel` iterations and the detectors run once per call.
    The RRE snapshot buffer is local to the chunk, as in the JAX package:
    a cycle needs rre_every * (rre_depth + 1) iterations within one call."""
    st = case.settings
    k_per_call = st.steps_per_kernel if st.fused_step else 1
    buf = None
    if st.rre_every > 0:
        buf = rre.empty_buffer(st.rre_depth,
                               rre.flat_size(case.mesh.nx, case.mesh.ny),
                               state.u.dtype, state.u.device)
    i = 0
    # each pass advances i by k_per_call >= 1, so n_steps passes bound it
    for _ in range(n_steps):
        if not (i < n_steps and _active(state, st.max_iterations)):
            break
        state = simple_step(state, case, profile, nu=nu)
        if buf is not None:
            state, buf = _rre_update(state, buf, case, profile)
        state = apply_detectors(state, st)
        i += k_per_call
    return state


def run_to_convergence(state: SolverState, profile: Optional[BFSInletProfile],
                       case: CaseConfig, nu=None) -> SolverState:
    """The whole solve as one host loop of `simple_step` (each call
    `steps_per_kernel` steps with `fused_step`) until the state is
    converged, diverged or at `max_iterations`; no detectors, as in the
    JAX package's single `while_loop`. `nu` overrides the viscosity (the
    sweep's per-case nu)."""
    max_iterations = case.settings.max_iterations
    # every call advances the count by at least one step
    for _ in range(max_iterations + 1):
        if not _active(state, max_iterations):
            break
        state = simple_step(state, case, profile, nu=nu)
    return state


class ResidualHistory:
    """Residual trace sampled once per chunk."""

    def __init__(self):
        self.data: Dict[str, list] = {"u": [], "v": [], "p": []}
        self.iterations: list = []

    def append(self, count: int, rms: np.ndarray):
        self.iterations.append(count)
        for k, val in zip(("u", "v", "p"), rms):
            self.data[k].append(float(val))

    def __getitem__(self, k):
        return self.data[k]

    def __len__(self):
        return len(self.iterations)


class DivergenceError(ValueError):
    """Raised when residuals go NaN/Inf."""


class CFDSolver:
    """User-facing solver with the reference's `CFDSolver` surface:
    construct from mesh / fluid / settings / BCs, call `.solve()`, read
    `.Var` or `.interior_fields()`. `device` defaults to "cuda"; a CUDA
    device that is not there raises."""

    def __init__(
        self,
        mesh: MeshParameters,
        fluid: FluidProperties,
        solver_settings: SolverSettings,
        bc: BoundaryConditions,
        bfs: Optional[BFSGeometry] = None,
        case_name: str = "lid driven cavity",
        bc_label: str = "lid_driven_cavity",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.case = CaseConfig.build(
            mesh, fluid, solver_settings, bc, bfs=bfs,
            case_name=case_name, bc_label=bc_label,
        )
        _big_grid_notices(self.case)
        self.profile = inlet_profile(self.case, self.device)
        self.state = init_state(self.case, self.device)
        self.residual_history = ResidualHistory()
        self._nu = torch.tensor(self.case.fluid.nu,
                                dtype=torch_dtype(self.case), device=self.device)

    def precompile(self) -> float:
        """Build the CUDA kernels this case uses (at first use in the
        process), capture its V-cycle's graph and build its tiled loop, so
        that none of it stays in the timed solve; returns the seconds
        spent."""
        t0 = time.perf_counter()
        st = self.settings
        if self.device.type == "cuda" and (st.use_pallas or st.fused_step
                                           or st.pressure_solver == "tiled"):
            from ..ops.kernel_lib import load_library

            load_library()
        if self.device.type == "cuda" and (
                st.fused_step or st.pressure_solver == "tiled"
                or (st.use_pallas and st.pressure_solver == "multigrid")):
            # one step from the state, discarded: the first launch of each
            # kernel pays its module load, the V-cycle's graph is captured
            # (ops/mg_kernels.cached_cycle, stream_kernels.StreamLevels.cycle)
            # and the tiled loop built (tiled_kernels.cached_loop) here, not
            # in the timed solve
            one = dataclasses.replace(
                self.case, settings=dataclasses.replace(st, steps_per_kernel=1))
            simple_step(self.state, one, self.profile, nu=self._nu)
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @property
    def mesh(self) -> MeshParameters:
        return self.case.mesh

    @property
    def fluid(self) -> FluidProperties:
        return self.case.fluid

    @property
    def settings(self) -> SolverSettings:
        return self.case.settings

    @property
    def Var(self) -> np.ndarray:
        return self.state.var()

    @property
    def nVar(self) -> int:
        return 3

    def interior_fields(self) -> Dict[str, np.ndarray]:
        return self.state.interior_fields()

    def warm_start(self, fields: Dict[str, np.ndarray], count: int = 0) -> None:
        """Initialise from (ny, nx) interior fields; `count` restores the
        iteration counter."""
        self.state = warm_start_state(self.case, fields, self.device)
        if count:
            self.state = self.state.replace(count=int(count))

    def resume_from(self, path: str) -> None:
        """Resume from an `io.checkpoint` .npz snapshot (fields and
        iteration count; the format `SpmdSolver.checkpoint` and the JAX
        package write)."""
        from ..io.checkpoint import load_solver_count, load_solver_fields

        self.warm_start(load_solver_fields(path), count=load_solver_count(path))

    def solve(
        self,
        output_base_name: str = "output",
        verbose: bool = True,
        log_convergence: bool = False,
        save_results: bool = True,
        snapshot_every: int = 0,
        profile_dir: Optional[str] = None,
    ) -> Tuple[int, float]:
        """Run to convergence or max_iterations; returns (iterations,
        elapsed_seconds). The host checks run once per `chunk_size`
        iterations, as in the JAX package.

        `snapshot_every` > 0 writes a restartable snapshot
        (`{output_base_name}_snapshot.npz`, `io.checkpoint.save_solver_state`)
        at the first chunk boundary N or more iterations after the last;
        `resume_from` restores it. `profile_dir` captures a torch.profiler
        trace of the solve there (`utils.timing.profile_trace`)."""
        st = self.case.settings
        start = time.time()
        last_snapshot = 0
        log_file = None
        if log_convergence:
            log_file = open(f"{output_base_name}_convergence.log", "w")
            log_file.write("# Convergence History\n")
            log_file.write(f"# Reynolds number: {self.case.fluid.Re}\n")
            log_file.write(f"# Mesh: {self.mesh.nx}x{self.mesh.ny}\n")
            log_file.write(f"# Time step: {st.dt}\n")
            log_file.write(f"# Scheme: {st.scheme}\n")
            log_file.write("# Iteration\tU_RMS\t\tV_RMS\t\tP_RMS\t\tTime(s)\n")
        if verbose:
            print(f"Starting simulation with Re={self.case.fluid.Re}, "
                  f"mesh={self.mesh.nx}x{self.mesh.ny}")
            print(f"Time step: {st.dt}, Scheme: {st.scheme}")
            print("\nIteration\tU-RMS\t\tV-RMS\t\tP-RMS")
            print("-" * 60)

        rms_window: list = []
        trace = profile_trace(profile_dir) if profile_dir else contextlib.nullcontext()
        with trace:
            try:
                # each chunk runs >= 1 step unless the state is inactive, and an
                # inactive state ends the loop below, so max_iterations + 1
                # passes bound it
                for _ in range(st.max_iterations + 1):
                    self.state = run_chunk(self.state, self.profile, self.case,
                                           st.chunk_size, nu=self._nu)
                    count = self.state.count
                    rms = self.state.rms
                    self.residual_history.append(count, rms)
                    if verbose:
                        print(f"{count}\t{rms[0]:.6e}\t{rms[1]:.6e}\t{rms[2]:.6e}")
                    if log_file:
                        log_file.write(
                            f"{count}\t{rms[0]:.6e}\t{rms[1]:.6e}\t{rms[2]:.6e}"
                            f"\t{time.time() - start:.3f}\n")
                        log_file.flush()
                    if self.state.diverged:
                        raise DivergenceError(
                            f"Solution diverged at iteration {count}: "
                            f"RMS = {rms.tolist()} (NaN/Inf detected). "
                            f"Try a smaller dt or stronger under-relaxation.")
                    if snapshot_every and count - last_snapshot >= snapshot_every:
                        from ..io.checkpoint import save_solver_state

                        save_solver_state(f"{output_base_name}_snapshot.npz", self.state)
                        last_snapshot = count
                    if self.state.converged or count >= st.max_iterations:
                        crit = np.asarray([st.criterion(c) for c in ("u", "v", "p")])
                        if verbose and self.state.converged and np.any(rms > crit):
                            print(f"Stopping at iteration {count}: device-side "
                                  f"plateau (working-precision convergence)")
                        break
                    if st.plateau_patience > 0:
                        rms_window.append(rms)
                        n = st.plateau_patience
                        if len(rms_window) >= 2 * n:
                            recent = np.median(rms_window[-n:], axis=0)
                            prior = np.median(rms_window[-2 * n:-n], axis=0)
                            if np.all(recent >= (1.0 - st.plateau_rtol) * prior):
                                if verbose:
                                    print(f"Stopping at iteration {count}: "
                                          f"residuals plateaued (working-"
                                          f"precision convergence)")
                                break
                            rms_window = rms_window[-2 * n:]
            finally:
                if log_file:
                    log_file.close()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        elapsed = time.time() - start
        if verbose:
            print(f"\nSimulation completed in {elapsed:.2f} seconds")
            print(f"Total iterations: {self.state.count}")
        if save_results:
            from ..io.results import save_all_results

            save_all_results(self, output_base_name)
        return self.state.count, elapsed
