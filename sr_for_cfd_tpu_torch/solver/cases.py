"""Flow-case presets: lid-driven cavity, backward-facing step and a custom
case from dicts (counterpart of `sr_for_cfd_tpu/solver/cases.py`).

The `create_*` functions build a solver, run it and return (solver,
iterations, seconds), with the JAX package's signatures; `device` travels
in `**kw` to `make_*_solver` (or is a keyword of `create_custom_case`) and
defaults to the card. `save_results=True` writes the run's artifact suite
(`io/results.save_all_results`: the two .dat files always, the HDF5 group
and the PNGs where h5py and matplotlib are installed).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..config import (
    BFSGeometry,
    BoundaryCondition,
    BoundaryConditions,
    FluidProperties,
    MeshParameters,
    SolverSettings,
)
from .simple import CFDSolver


def make_cavity_solver(
    Re: float = 100,
    nx: int = 100,
    ny: int = 100,
    dt: float = 0.001,
    scheme: str = "QUICK",
    convergence_criteria: Optional[Dict[str, float]] = None,
    max_iterations: int = 100000,
    double_lid: bool = False,
    bc: Optional[BoundaryConditions] = None,
    device="cuda",
    **settings_kw,
) -> CFDSolver:
    """Build (but don't run) a lid-driven-cavity solver."""
    mesh = MeshParameters(nx=nx, ny=ny, lx=1.0, ly=1.0)
    fluid = FluidProperties(Re=Re, rho=1.0)
    settings = SolverSettings.make(
        dt=dt, scheme=scheme, convergence_criteria=convergence_criteria,
        max_iterations=max_iterations, **settings_kw,
    )
    if bc is None:
        bc = (BoundaryConditions.double_lid_cavity() if double_lid
              else BoundaryConditions.lid_driven_cavity())
    case_name = "double lid driven cavity" if double_lid else "lid driven cavity"
    bc_label = ("double_lid(u_top=1,u_bottom=1)" if double_lid
                else "lid_driven_cavity")
    return CFDSolver(mesh, fluid, settings, bc, case_name=case_name,
                     bc_label=bc_label, device=device)


def create_lid_driven_cavity(
    Re: float = 100,
    nx: int = 100,
    ny: int = 100,
    dt: float = 0.001,
    output_name: str = "cavity_Re100",
    scheme: str = "QUICK",
    convergence_criteria: Optional[Dict[str, float]] = None,
    verbose: bool = True,
    save_results: bool = True,
    **kw,
) -> Tuple[CFDSolver, int, float]:
    """Create and solve a lid-driven cavity; returns (solver, iterations,
    seconds)."""
    solver = make_cavity_solver(
        Re=Re, nx=nx, ny=ny, dt=dt, scheme=scheme,
        convergence_criteria=convergence_criteria, **kw)
    iterations, elapsed = solver.solve(output_name, verbose=verbose,
                                       save_results=save_results)
    return solver, iterations, elapsed


def make_bfs_solver(
    Re: float = 400,
    nx: int = 400,
    ny: int = 194,
    dt: float = 2e-3,
    scheme: str = "UPWIND",
    relaxation_factors: Optional[Dict[str, float]] = None,
    convergence_criteria: Optional[Dict[str, float]] = None,
    max_iterations: int = 100000,
    lx: float = 10.0,
    ly: float = 3.0,
    step_height: float = 1.0,
    h: float = 2.0,
    Ub: float = 1.0,
    bc: Optional[BoundaryConditions] = None,
    device="cuda",
    **settings_kw,
) -> CFDSolver:
    """Backward-facing-step solver: lx=10, ly=3 channel, step height 1,
    inlet opening h=2, Ub=1, UPWIND and under-relaxation (0.5, 0.5, 0.2)."""
    mesh = MeshParameters(nx=nx, ny=ny, lx=lx, ly=ly)
    fluid = FluidProperties(Re=Re, rho=1.0)
    if relaxation_factors is None:
        relaxation_factors = {"u": 0.5, "v": 0.5, "p": 0.2}
    settings = SolverSettings.make(
        dt=dt, scheme=scheme, convergence_criteria=convergence_criteria,
        relaxation_factors=relaxation_factors, max_iterations=max_iterations,
        **settings_kw,
    )
    if bc is None:
        bc = BoundaryConditions.bfs()
    geom = BFSGeometry(step_height=step_height, h=h, Ub=Ub)
    return CFDSolver(mesh, fluid, settings, bc, bfs=geom,
                     case_name="backward facing step",
                     bc_label="bfs_parabolic_inlet", device=device)


def create_bfs_case(
    nx: int = 400,
    ny: int = 194,
    dt: float = 2e-3,
    scheme: str = "UPWIND",
    output_name: str = "bfs_Re400",
    relaxation_factors: Optional[Dict[str, float]] = None,
    Re: float = 400,
    verbose: bool = True,
    save_results: bool = True,
    log_convergence: bool = True,
    **kw,
) -> Tuple[CFDSolver, int, float]:
    """Create and solve a backward-facing-step case; returns (solver,
    iterations, seconds). `log_convergence` writes
    `{output_name}_convergence.log`."""
    solver = make_bfs_solver(
        Re=Re, nx=nx, ny=ny, dt=dt, scheme=scheme,
        relaxation_factors=relaxation_factors, **kw)
    iterations, elapsed = solver.solve(
        output_name, verbose=verbose, log_convergence=log_convergence,
        save_results=save_results)
    return solver, iterations, elapsed


def create_custom_case(
    mesh_params: Dict,
    fluid_params: Dict,
    solver_params: Dict,
    bc_params: Dict,
    output_name: str = "custom_case",
    verbose: bool = True,
    save_results: bool = True,
    device="cuda",
) -> Tuple[CFDSolver, int, float]:
    """Create and solve a case from dicts: the keyword arguments of
    `MeshParameters`, `FluidProperties` and `SolverSettings.make`, and
    per-variable boundary conditions, e.g. ``{"u_boundaries": {"top":
    {"type": "dirichlet", "value": 1.0}}}``, over the lid-driven cavity's
    defaults. Returns (solver, iterations, seconds)."""
    mesh = MeshParameters(**mesh_params)
    fluid = FluidProperties(**fluid_params)
    settings = SolverSettings.make(**solver_params)
    bc = BoundaryConditions()
    for var in ("u", "v", "p"):
        key = f"{var}_boundaries"
        if key in bc_params:
            target = getattr(bc, key)
            for wall, condition in bc_params[key].items():
                target[wall] = BoundaryCondition(**condition)
    solver = CFDSolver(mesh, fluid, settings, bc, case_name="custom case",
                       bc_label="custom", device=device)
    iterations, elapsed = solver.solve(output_name, verbose=verbose,
                                       save_results=save_results)
    return solver, iterations, elapsed
