"""Case/configuration layer: meshes, fluids, boundary conditions, settings.

PyTorch-port counterpart of `sr_for_cfd_tpu/config.py`. The dataclasses,
presets, `SolverSettings` validation and `CaseConfig.build` keep the JAX
package's names, defaults and semantics, so a case built here describes the
same flow as one built there, and both refuse the same configurations
with the same `ValueError` texts (the TPU VMEM gate of `CaseConfig.build`
included: the port mirrors the JAX package's TPU limits as refusals, so
that both accept the same set). A case with `spmd_devices > 1` is run by
the row-decomposed `parallel.spmd_step.SpmdSolver`; the single-device
solver refuses to step it, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

SIDES = ("left", "right", "top", "bottom")

DIRICHLET = "dirichlet"
NEUMANN = "neumann"

QUICK = "QUICK"
UPWIND = "UPWIND"

# Interior-cell count past which use_pallas takes the big-grid kernel path
# (solver/simple.py: the tiled momentum kernel and the streamed V-cycle).
# The JAX package draws the line here because its resident V-cycle kernel
# outgrows the TPU's VMEM; the port keeps the line so that both packages
# route, count and refuse alike.
STREAM_MG_CELL_THRESHOLD = 1_350_000


@dataclass(frozen=True)
class BoundaryCondition:
    """One side's boundary condition."""

    type: str = DIRICHLET  # 'dirichlet' or 'neumann'
    value: float = 0.0

    def __post_init__(self):
        if self.type not in (DIRICHLET, NEUMANN):
            raise ValueError(f"Unknown BC type {self.type!r}")


def _bc_map(**kwargs: BoundaryCondition) -> Dict[str, BoundaryCondition]:
    return {s: kwargs.get(s, BoundaryCondition(DIRICHLET, 0.0)) for s in SIDES}


@dataclass(frozen=True)
class VariableBCs:
    """Per-variable BCs for the four sides (frozen, hashable)."""

    left: BoundaryCondition = BoundaryCondition()
    right: BoundaryCondition = BoundaryCondition()
    top: BoundaryCondition = BoundaryCondition()
    bottom: BoundaryCondition = BoundaryCondition()

    def __getitem__(self, side: str) -> BoundaryCondition:
        return getattr(self, side)

    def replace(self, **kw) -> "VariableBCs":
        return dataclasses.replace(self, **kw)


class BoundaryConditions:
    """Container for u/v/p boundary conditions; the default is the
    single-lid-driven cavity (u_top = 1, no-slip elsewhere, pressure
    Neumann everywhere)."""

    def __init__(self):
        self.u_boundaries: Dict[str, BoundaryCondition] = _bc_map(
            top=BoundaryCondition(DIRICHLET, 1.0)
        )
        self.v_boundaries: Dict[str, BoundaryCondition] = _bc_map()
        self.p_boundaries: Dict[str, BoundaryCondition] = {
            s: BoundaryCondition(NEUMANN, 0.0) for s in SIDES
        }

    @classmethod
    def lid_driven_cavity(cls, lid_velocity: float = 1.0) -> "BoundaryConditions":
        bc = cls()
        bc.u_boundaries["top"] = BoundaryCondition(DIRICHLET, lid_velocity)
        return bc

    @classmethod
    def double_lid_cavity(cls, lid_velocity: float = 1.0) -> "BoundaryConditions":
        bc = cls()
        bc.u_boundaries["top"] = BoundaryCondition(DIRICHLET, lid_velocity)
        bc.u_boundaries["bottom"] = BoundaryCondition(DIRICHLET, lid_velocity)
        return bc

    @classmethod
    def bfs(cls) -> "BoundaryConditions":
        """Backward-facing step: velocity Neumann at the outlet (right),
        walls top/bottom, left overridden by the inlet profile; pressure
        Dirichlet 0 at the outlet, Neumann elsewhere."""
        bc = cls()
        bc.u_boundaries = _bc_map(right=BoundaryCondition(NEUMANN, 0.0))
        bc.v_boundaries = _bc_map(right=BoundaryCondition(NEUMANN, 0.0))
        bc.p_boundaries = {
            "left": BoundaryCondition(NEUMANN, 0.0),
            "right": BoundaryCondition(DIRICHLET, 0.0),
            "top": BoundaryCondition(NEUMANN, 0.0),
            "bottom": BoundaryCondition(NEUMANN, 0.0),
        }
        return bc

    def frozen(self, var: str) -> VariableBCs:
        d = {"u": self.u_boundaries, "v": self.v_boundaries,
             "p": self.p_boundaries}[var]
        return VariableBCs(**{s: d[s] for s in SIDES})


@dataclass(frozen=True)
class MeshParameters:
    """Uniform collocated grid with one ghost ring."""

    nx: int = 100
    ny: int = 100
    lx: float = 1.0
    ly: float = 1.0

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def volp(self) -> float:
        return self.dx * self.dy


@dataclass(frozen=True)
class FluidProperties:
    """Non-dimensional fluid: nu = 1/Re with U = L = 1."""

    Re: float = 100.0
    rho: float = 1.0

    @property
    def nu(self) -> float:
        return 1.0 / self.Re


@dataclass(frozen=True)
class BFSGeometry:
    """Backward-facing-step inlet: no-slip wall below `step_height`,
    parabolic inlet 6 Ub (y'/h)(1 - y'/h) over the opening of height h."""

    step_height: float = 1.0
    h: float = 2.0
    Ub: float = 1.0


_DEFAULT_CRITERIA = (("u", 1e-6), ("v", 1e-6), ("p", 1e-6), ("continuity", 1e-6))
_NO_RELAX = (("u", 1.0), ("v", 1.0), ("p", 1.0))


@dataclass(frozen=True)
class SolverSettings:
    """Solver settings with the JAX package's fields and defaults (see
    `sr_for_cfd_tpu/config.py` for the measured reasons behind each).

    `use_pallas=True` keeps its name so that the two packages take the same
    keyword arguments; here it selects the hand-written CUDA pressure
    kernels (`ops/pressure_kernels.py` for 'sweeps', `ops/mg_kernels.py`
    for 'multigrid'); with forced slab rows or past
    STREAM_MG_CELL_THRESHOLD cells (`big_grid_kernels`) the momentum solves
    take the tiled momentum kernel (`ops/momentum_kernels.py`) and the
    multigrid pressure the streamed V-cycle (`ops/stream_kernels.py`), as
    in the JAX package. `pressure_solver='tiled'` (float32, without
    `use_pallas` or `fused_step`) runs the pressure on the one-pass tiled
    sweep kernel (`ops/tiled_kernels.py`). `fused_step=True` runs every
    outer step, or `steps_per_kernel` of them per launch, through the
    whole-step kernel (`ops/step_kernels.py`). On a CPU tensor each wrapper runs its plain
    PyTorch version, which is how the tests reach them.
    """

    dt: float = 0.001
    max_iterations: int = 100000
    convergence_criteria: Tuple[Tuple[str, float], ...] = _DEFAULT_CRITERIA
    scheme: str = QUICK
    relaxation_factors: Tuple[Tuple[str, float], ...] = _NO_RELAX
    inner_tolerance: float = 1e-6
    inner_max_iter: int = 1000
    inner_scheme: str = "redblack"
    momentum_check_every: int = 1
    pressure_check_every: int = 8
    pressure_sor: float = 1.0
    pressure_solver: str = "sweeps"
    plateau_patience: int = 0
    plateau_rtol: float = 0.01
    plateau_check_every: int = 2000
    convergence_hold: int = 1
    cauchy_tol: float = 0.0
    cauchy_check_every: int = 5000
    rre_every: int = 0
    rre_depth: int = 6
    rre_min_count: int = 0
    mg_n_pre: int = 4
    mg_n_post: int = 4
    mg_min_size: int = 8
    mg_coarsest_sweeps: int = 40
    mg_smoother_sor: float = 1.5
    mg_slab_rows: int = 0
    spmd_devices: int = 1
    dtype: str = "float32"
    chunk_size: int = 100
    use_pallas: bool = False
    fused_step: bool = False
    steps_per_kernel: int = 1

    def __post_init__(self):
        if self.scheme not in (QUICK, UPWIND):
            raise ValueError(f"Unknown scheme {self.scheme!r}")
        if self.inner_scheme not in ("redblack", "jacobi"):
            raise ValueError(f"Unknown inner scheme {self.inner_scheme!r}")
        if self.pressure_solver not in ("sweeps", "multigrid", "tiled"):
            raise ValueError(
                f"Unknown pressure solver {self.pressure_solver!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"Unknown dtype {self.dtype!r}")
        if self.rre_every > 0 and self.rre_depth < 2:
            raise ValueError(
                "rre_depth must be >= 2 (scalar Aitken cannot cancel the "
                "oscillatory error modes these flows produce; see "
                "ops/extrapolate.py)"
            )
        if self.rre_every > 0:
            cycle = self.rre_every * (self.rre_depth + 1)
            if self.chunk_size < cycle:
                # the snapshot buffer is chunk-local (solver/simple.py
                # run_chunk): a shorter chunk would never jump
                raise ValueError(
                    f"rre_every={self.rre_every} with rre_depth="
                    f"{self.rre_depth} needs rre_every*(rre_depth+1)="
                    f"{cycle} iterations per chunk to fire, but "
                    f"chunk_size={self.chunk_size}; raise chunk_size "
                    "(RRE targets long single-dispatch solves) or lower "
                    "rre_every/rre_depth"
                )
        if self.steps_per_kernel < 1:
            raise ValueError("steps_per_kernel must be >= 1")
        if self.steps_per_kernel > 1:
            if not self.fused_step:
                raise ValueError(
                    "steps_per_kernel > 1 requires fused_step=True (it is "
                    "a property of the fused Pallas kernel)"
                )
            if self.convergence_hold > 1:
                raise ValueError(
                    "steps_per_kernel > 1 is incompatible with "
                    "convergence_hold > 1 (the hold counts per-iteration "
                    "crossings, which a multi-step kernel cannot observe)"
                )
            # detector checks run once per launch and fire on exact
            # multiples of their cadence
            cadences = [("chunk_size", self.chunk_size)]
            if self.cauchy_tol > 0.0:
                cadences.append(("cauchy_check_every", self.cauchy_check_every))
            if self.plateau_patience > 0:
                cadences.append(
                    ("plateau_check_every", self.plateau_check_every))
            if self.rre_every > 0:
                cadences.append(("rre_every", self.rre_every))
            for name, v in cadences:
                if v % self.steps_per_kernel != 0:
                    raise ValueError(
                        f"steps_per_kernel={self.steps_per_kernel} must "
                        f"divide {name}={v} (detector checks run once per "
                        "kernel launch and fire on exact multiples)"
                    )
        if self.mg_slab_rows < 0 or self.mg_slab_rows % 16:
            raise ValueError(
                "mg_slab_rows must be 0 (auto) or a positive multiple of "
                "16 (keeps the streamed kernel's restrict/prolong slice "
                "offsets (i-1)*R/2 sublane-aligned for Mosaic)"
            )
        if self.mg_slab_rows > 0 and not (
                self.pressure_solver == "multigrid" and self.use_pallas):
            raise ValueError(
                "mg_slab_rows applies to the Pallas multigrid pressure "
                "path only (pressure_solver='multigrid', use_pallas=True)"
            )
        if self.mg_slab_rows > 0 and self.fused_step:
            raise ValueError(
                "mg_slab_rows (streamed multigrid) is incompatible with "
                "fused_step: the fused whole-step kernel is VMEM-resident"
            )
        if self.pressure_solver == "tiled" and self.dtype != "float32":
            raise ValueError(
                "pressure_solver='tiled' is float32-only (Pallas kernel); "
                "use 'sweeps' or 'multigrid' for float64"
            )
        for flag in ("fused_step", "use_pallas"):
            if not getattr(self, flag):
                continue
            bad = []
            if self.dtype != "float32":
                bad.append(f"dtype={self.dtype!r} (Pallas kernels are float32)")
            allowed = ("sweeps", "multigrid")
            if self.pressure_solver not in allowed:
                bad.append(
                    f"pressure_solver={self.pressure_solver!r} (with "
                    f"{flag}, only {' / '.join(map(repr, allowed))} have "
                    "a fused Pallas kernel)"
                )
            if bad:
                raise ValueError(
                    f"{flag}=True is incompatible with "
                    + " and ".join(bad)
                    + f"; drop {flag} or the conflicting option"
                )

    @staticmethod
    def make(
        dt: float = 0.001,
        max_iterations: int = 100000,
        convergence_criteria: Optional[Dict[str, float]] = None,
        scheme: str = QUICK,
        relaxation_factors: Optional[Dict[str, float]] = None,
        **kw,
    ) -> "SolverSettings":
        """Dict-friendly constructor matching the reference's signature."""
        crit = dict(_DEFAULT_CRITERIA)
        if convergence_criteria:
            crit.update(convergence_criteria)
        relax = dict(_NO_RELAX)
        if relaxation_factors:
            relax.update(relaxation_factors)
        return SolverSettings(
            dt=dt,
            max_iterations=max_iterations,
            convergence_criteria=tuple(sorted(crit.items())),
            scheme=scheme,
            relaxation_factors=tuple(sorted(relax.items())),
            **kw,
        )

    def criterion(self, var: str) -> float:
        return dict(self.convergence_criteria)[var]

    def relax(self, var: str) -> float:
        return dict(self.relaxation_factors)[var]


def big_grid_kernels(settings: SolverSettings, mesh: MeshParameters) -> bool:
    """The JAX package's `big_grid_pallas` rule: use_pallas with forced
    slab rows or past STREAM_MG_CELL_THRESHOLD interior cells takes the
    tiled momentum kernel and the streamed V-cycle."""
    return settings.use_pallas and (
        settings.mg_slab_rows > 0
        or mesh.nx * mesh.ny > STREAM_MG_CELL_THRESHOLD)


@dataclass(frozen=True)
class CaseConfig:
    """One fully-specified flow case."""

    mesh: MeshParameters
    fluid: FluidProperties
    settings: SolverSettings
    u_bc: VariableBCs
    v_bc: VariableBCs
    p_bc: VariableBCs
    bfs: Optional[BFSGeometry] = None
    case_name: str = "lid driven cavity"
    bc_label: str = "lid_driven_cavity"

    @classmethod
    def build(
        cls,
        mesh: MeshParameters,
        fluid: FluidProperties,
        settings: SolverSettings,
        bc: BoundaryConditions,
        bfs: Optional[BFSGeometry] = None,
        case_name: str = "lid driven cavity",
        bc_label: str = "lid_driven_cavity",
    ) -> "CaseConfig":
        # the JAX package's VMEM gate, kept with its message so that both
        # packages accept the same configurations (the CUDA kernels would
        # take these grids)
        vmem_resident = settings.fused_step or (
            settings.use_pallas and settings.pressure_solver != "multigrid")
        if vmem_resident:
            est = (mesh.nx + 2) * (mesh.ny + 2) * 4 * 30
            if not settings.fused_step:
                est //= max(1, settings.spmd_devices)
            if est > 100 * 1024 * 1024:
                raise ValueError(
                    f"fused_step/use_pallas: {mesh.nx}x{mesh.ny} needs "
                    f"~{est / 2**20:.0f} MiB of VMEM (>100 MiB budget). Use "
                    "pressure_solver='multigrid' (use_pallas streams it "
                    "through VMEM at any size) for grids beyond ~900^2.")
        if settings.use_pallas and settings.pressure_solver == "multigrid":
            # the streamed V-cycle's own constraints, surfaced at config
            # time instead of the first pressure solve
            streams = big_grid_kernels(settings, mesh)
            if streams and (mesh.nx % 2 or mesh.ny % 2):
                raise ValueError(
                    "use_pallas + multigrid past the VMEM wall streams "
                    f"the V-cycle, which needs even nx, ny (got {mesh.nx}"
                    f"x{mesh.ny}); drop use_pallas or use an even grid"
                )
            if streams and (settings.mg_n_pre < 1 or settings.mg_n_post < 1):
                raise ValueError(
                    "the slab-streamed V-cycle needs mg_n_pre >= 1 and "
                    "mg_n_post >= 1 (its entry-residual RMS and halo "
                    "widths are built from the smoothing sweeps)"
                )
        return cls(
            mesh=mesh,
            fluid=fluid,
            settings=settings,
            u_bc=bc.frozen("u"),
            v_bc=bc.frozen("v"),
            p_bc=bc.frozen("p"),
            bfs=bfs,
            case_name=case_name,
            bc_label=bc_label,
        )
