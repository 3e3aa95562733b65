"""The row-decomposed solver's two full-width one-rank configurations.

`chip_smoke.py` drives them on the card and `scripts/torch_spmd_profile.py`
traces them, so that both measure the same cases:

* `SWEEPS_400`: the 400^2 lid-driven cavity of `__graft_entry__.py:148-152`
  (Re=1000, QUICK, dt=1e-3, float32) on the per-rank sweep kernel
  (`use_pallas`, `pressure_solver="sweeps"`), `SWEEPS_400_STEPS` steps;
* `MULTIGRID_2048`: `scripts/scaling_bench.py`'s 2048^2 cavity (Re=1000,
  QUICK, dt=1e-3, float32) on the sharded V-cycle whose smoother is the
  per-rank sweep kernel (`use_pallas`, `pressure_solver="multigrid"`), the
  bench's `MULTIGRID_2048_STEPS` steps.
"""

from __future__ import annotations

SWEEPS_400 = dict(Re=1000.0, nx=400, ny=400, dt=1e-3, scheme="QUICK", dtype="float32",
                  use_pallas=True, pressure_solver="sweeps")
SWEEPS_400_STEPS = 100
MULTIGRID_2048 = dict(Re=1000.0, nx=2048, ny=2048, dt=1e-3, scheme="QUICK",
                      dtype="float32", use_pallas=True, pressure_solver="multigrid")
MULTIGRID_2048_STEPS = 200


def cavity_case(kw: dict, steps: int):
    """The lid-driven cavity case of `solver/cases.make_cavity_solver` for
    the settings `kw` (with nx, ny and Re), `steps` outer steps in one
    chunk."""
    from ..config import (
        BoundaryConditions,
        CaseConfig,
        FluidProperties,
        MeshParameters,
        SolverSettings,
    )

    kw = dict(kw)
    mesh = MeshParameters(nx=kw.pop("nx"), ny=kw.pop("ny"), lx=1.0, ly=1.0)
    fluid = FluidProperties(Re=kw.pop("Re"), rho=1.0)
    settings = SolverSettings.make(max_iterations=steps, chunk_size=steps, **kw)
    return CaseConfig.build(mesh, fluid, settings, BoundaryConditions.lid_driven_cavity())
