"""Flow-case presets: lid-driven cavity and backward-facing step
(counterpart of `sr_for_cfd_tpu/solver/cases.py`)."""

from __future__ import annotations

from typing import Dict, Optional

from ..config import (
    BFSGeometry,
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
