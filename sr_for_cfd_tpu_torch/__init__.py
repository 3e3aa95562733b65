"""PyTorch/CUDA port of `sr_for_cfd_tpu`: the SIMPLE finite-volume solver,
the super-resolution autoencoder and the hybrid workflow, with the JAX
package's TPU kernels rewritten as hand-written CUDA kernels (`csrc/`).

Imports `torch` and numpy only; the JAX package stays the reference.
Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`:

    from sr_for_cfd_tpu_torch import create_lid_driven_cavity
    solver, iterations, seconds = create_lid_driven_cavity(Re=100, nx=64, ny=64)

The data-generation sweep and the SR training pipeline live in
`workflow.sweep` (`batched_cavity_solve`, `generate_training_data`) and
`workflow.training` (`train_sr_autoencoder`, `evaluate_for_re`,
`export_models`); like the JAX package, the top level re-exports none of
them, and `SRModel` (with `SRModel.create`) lazily.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    BFSGeometry,
    BoundaryCondition,
    BoundaryConditions,
    CaseConfig,
    FluidProperties,
    MeshParameters,
    SolverSettings,
)
from .solver.cases import (  # noqa: F401
    create_bfs_case,
    create_custom_case,
    create_lid_driven_cavity,
    make_bfs_solver,
    make_cavity_solver,
)
from .solver.simple import CFDSolver, DivergenceError  # noqa: F401
from .solver.state import SolverState, init_state, warm_start_state  # noqa: F401

# the JAX package's GSPMD solver, not ported yet
_UNPORTED = ("ShardedSolver",)


def __getattr__(name):
    # lazy re-exports of the heavier subsystems
    if name in ("SRModel", "ml_super_resolution"):
        from .sr import inference

        return getattr(inference, name)
    if name == "SpmdSolver":
        from .parallel.spmd_step import SpmdSolver

        return SpmdSolver
    if name == "batched_spmd_cavity_solve":
        from .parallel.spmd_batch import batched_spmd_cavity_solve

        return batched_spmd_cavity_solve
    if name == "run_hybrid_experiment":
        from .workflow.hybrid import run_hybrid_experiment

        return run_hybrid_experiment
    if name in _UNPORTED:
        raise AttributeError(
            f"{name} is not ported to the PyTorch package yet (the GSPMD "
            "solver parallel/domain.py: ROADMAP queue A, item A11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
