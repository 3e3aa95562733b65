"""Data-generation sweep: cavity solves over Re x mesh size -> HDF5
(counterpart of `sr_for_cfd_tpu/workflow/sweep.py`).

The JAX package vmaps the SIMPLE step over the Reynolds axis, with a nu
per case, and freezes a case once it has converged, diverged or spent its
budget. Here `batched_cavity_solve` takes one of two routes:

* fused and design (a) fits (`fused_step=True`, point-iteration pressure,
  a grid whose fields fit one block's shared memory): the counterpart of
  JAX's vmapped `pallas_call`. Each launch of
  `step_kernels.simple_step_small_batched` runs `steps_per_kernel` steps of
  every active case, one block per case, and the host reads all cases'
  residuals once per launch.
* any other configuration (non-fused, or fused on design (b): 400x400 or
  the multigrid mode): a loop over the cases, each on the single-case
  step. JAX's masked vmap gives each case its solo trajectory, so the
  loop is the same result.

Either way a case stops on converged, diverged or `max_iterations` and its
fields, count and residuals then stay as they were; the host prints one
progress line per chunk of `chunk_size` iterations, and diverged cases are
dropped from the result with a message.

The JAX package shards the case axis over a device mesh; here
`mesh_devices` (a `parallel.mesh.Mesh`) gives each rank of a process group
its contiguous block of the cases, which it solves on one of the routes
above. The ranks share their counts after each chunk and their fields at
the end, so every rank returns the whole result. `generate_training_data`
routes `spmd_devices=M > 1` to `parallel/spmd_batch.py` (cases over ranks,
each case's rows over M of them) and writes its HDF5 files from rank 0.
Where the case x M mesh would not take every rank (JAX leaves such devices
idle), every rank takes the case-parallel path instead, with the notice.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MeshParameters
from ..io.hdf5 import save_fields_hdf5
from ..ops.stencil import FaceFluxes
from ..ops.step_kernels import simple_step_small_batched, small_fits
from ..parallel import mesh as ring
from ..solver.cases import make_cavity_solver
from ..solver.simple import _active, simple_step
from ..solver.state import SolverState
from ..utils.naming import fmt_re

DEFAULT_REYNOLDS = tuple(range(100, 801, 100))
DEFAULT_MESH_SIZES = (10, 50, 400)


def _auto_steps_per_kernel(settings_kw: Dict, max_iterations: int,
                           verbose: bool) -> None:
    """The JAX sweep's multi-step default for fused sweeps: the largest K of
    (500, 250, 100, 50, 10) that divides the chunk and the budget, unless a
    detector option (whose cadence must divide K) or K itself is given."""
    detector_opts = ("cauchy_tol", "plateau_patience", "rre_every",
                     "convergence_hold", "steps_per_kernel")
    if settings_kw.get("fused_step") and not any(
            k in settings_kw for k in detector_opts):
        cs = settings_kw["chunk_size"]
        for k in (500, 250, 100, 50, 10):
            # K must divide the chunk AND the iteration budget: exit checks
            # fire every K iterations, so a K that doesn't divide
            # max_iterations would overrun the recorded budget
            if cs % k == 0 and max_iterations % k == 0:
                settings_kw["steps_per_kernel"] = k
                if verbose:  # no silent behavior changes for callers
                    print(f"[sweep] fused sweeps: auto-enabled "
                          f"steps_per_kernel={k} (convergence checked "
                          f"every {k} iterations)")
                break


class _Batched:
    """The batched route: the cases as stacked tensors on the device, each
    case's count and exit flags on the host."""

    def __init__(self, case, profile, state0: SolverState, nus: torch.Tensor):
        n = nus.shape[0]

        def stack(t):
            return t.unsqueeze(0).repeat((n,) + (1,) * t.dim()).contiguous()

        self.case, self.profile, self.nus = case, profile, nus
        self.u, self.v, self.p = stack(state0.u), stack(state0.v), stack(state0.p)
        self.ff = FaceFluxes(*(stack(t) for t in state0.ff))
        self.count = np.full(n, state0.count, dtype=np.int64)
        self.converged = np.zeros(n, dtype=bool)
        self.diverged = np.zeros(n, dtype=bool)

    def active(self) -> np.ndarray:
        st = self.case.settings
        return ~(self.converged | self.diverged) & (self.count < st.max_iterations)

    def chunk(self, chunk_size: int) -> None:
        """Launches of K steps of every active case, while the chunk lasts
        and a case is active, each followed by one host read of all cases'
        residuals."""
        st, mesh = self.case.settings, self.case.mesh
        crit = [st.criterion("u"), st.criterion("v"), st.criterion("p")]
        i = 0
        while i < chunk_size:
            idx = np.flatnonzero(self.active())
            if idx.size == 0:
                return
            self.u, self.v, self.p, self.ff, res, _ = simple_step_small_batched(
                self.u, self.v, self.p, self.ff, self.case, self.profile, self.nus, idx)
            # the single-case step's rms, element by element (solver/simple.py)
            rms = (torch.sqrt(res / (mesh.nx * mesh.ny)) / st.dt).cpu().numpy()
            batched_cavity_solve.reads += 1
            crit_t = np.asarray(crit, dtype=rms.dtype)
            for b in idx:
                self.count[b] += st.steps_per_kernel
                self.converged[b] = bool(np.all(rms[b] <= crit_t))
                self.diverged[b] = not bool(np.all(np.isfinite(rms[b])))
            i += st.steps_per_kernel

    def interior(self, b: int) -> torch.Tensor:
        """Case b's (3, ny, nx) interior u, v, p."""
        return torch.stack([getattr(self, c)[b, 1:-1, 1:-1].T for c in "uvp"])


class _Looped:
    """The loop route: one single-case state per case, each advanced on the
    single-case step."""

    def __init__(self, case, profile, state0: SolverState, nus: torch.Tensor):
        self.case, self.profile, self.nus = case, profile, nus
        self.states: List[SolverState] = [state0] * nus.shape[0]

    @property
    def count(self) -> np.ndarray:
        return np.asarray([s.count for s in self.states])

    @property
    def diverged(self) -> np.ndarray:
        return np.asarray([s.diverged for s in self.states])

    def active(self) -> np.ndarray:
        max_iterations = self.case.settings.max_iterations
        return np.asarray([_active(s, max_iterations) for s in self.states])

    def chunk(self, chunk_size: int) -> None:
        st = self.case.settings
        k_per_call = st.steps_per_kernel if st.fused_step else 1
        for b, s in enumerate(self.states):
            i = 0
            while i < chunk_size and _active(s, st.max_iterations):
                s = simple_step(s, self.case, self.profile, nu=self.nus[b])
                i += k_per_call
            self.states[b] = s

    def interior(self, b: int) -> torch.Tensor:
        return torch.stack([getattr(self.states[b], c)[1:-1, 1:-1].T for c in "uvp"])


def batched_cavity_solve(
    reynolds: Sequence[float],
    nx: int,
    ny: int,
    dt: float = 1e-3,
    scheme: str = "QUICK",
    double_lid: bool = True,
    max_iterations: int = 100000,
    mesh_devices=None,
    verbose: bool = True,
    chunk_size: int = 1000,
    device="cuda",
    **settings_kw,
) -> Tuple[Dict[float, Dict[str, np.ndarray]], np.ndarray]:
    """Solve one cavity mesh size for all Reynolds numbers: each case with
    its own nu = 1/Re, frozen once it stops (see the module docstring for
    the two routes). With `mesh_devices` (a `parallel.mesh.Mesh`) the cases
    are split over its 'dp' axis in contiguous blocks, which must be equal.

    Returns ({Re: {u, v, p} interior (ny, nx) fields}, iterations[n]), on
    every rank of the mesh.
    """
    res = np.asarray(list(reynolds), dtype=np.float64)
    n = len(res)
    mine = slice(0, n)
    if mesh_devices is not None:
        mine = ring.batch_sharding(mesh_devices).block(n)
    # mirror the sweep's own chunk size into the settings so options
    # validated against it (steps_per_kernel divisibility) line up
    settings_kw.setdefault("chunk_size", chunk_size)
    _auto_steps_per_kernel(settings_kw, max_iterations, verbose)
    solver = make_cavity_solver(
        Re=float(res[0]), nx=nx, ny=ny, dt=dt, scheme=scheme,
        double_lid=double_lid, max_iterations=max_iterations, device=device,
        **settings_kw,
    )
    case, state0 = solver.case, solver.state
    st = case.settings
    dev = state0.u.device
    nus = torch.tensor(1.0 / res[mine], dtype=state0.u.dtype, device=dev)
    batched = (st.fused_step and st.pressure_solver != "multigrid"
               and small_fits(nx + 2, ny + 2))
    cases = (_Batched if batched else _Looped)(case, solver.profile, state0, nus)

    def everyone(x) -> torch.Tensor:
        """Each rank's block of a per-case tensor, stacked in case order."""
        return x if mesh_devices is None else ring.all_gather(x, mesh_devices)

    def status():
        """(counts, active, diverged) of all n cases."""
        mine_t = torch.tensor(np.stack([cases.count, cases.active(), cases.diverged], 1),
                              dtype=torch.float64, device=dev)
        c, a, d = everyone(mine_t).cpu().numpy().T
        return c.astype(np.int64), a.astype(bool), d.astype(bool)

    # each chunk advances every active case by at least one step
    for _ in range(max_iterations + 1):
        cases.chunk(chunk_size)
        count, active, diverged = status()
        if verbose and ring.is_rank0():
            print(f"  sweep {nx}x{ny}: iters {count.min()}..{count.max()}, "
                  f"{active.sum()}/{n} active")
        if not active.any():
            break

    interior = everyone(torch.stack([cases.interior(b) for b in range(len(nus))]))
    interior = interior.cpu().numpy()
    # diverged cases hold frozen NaN fields: DROP them (announced) like
    # the reference's per-case try/except - one bad Re must not poison
    # the training HDF5 (NaN stats -> NaN loss downstream)
    fields = {float(re_val): {c: interior[i, k].copy() for k, c in enumerate("uvp")}
              for i, re_val in enumerate(res) if not diverged[i]}
    if len(fields) < len(res) and ring.is_rank0():
        dropped = [float(r) for i, r in enumerate(res) if diverged[i]]
        print(f"  sweep {nx}x{ny}: DROPPED diverged cases Re={dropped}")
    return fields, count.astype(np.int32)


# host reads of the batched route's residuals (one per launch)
batched_cavity_solve.reads = 0


def generate_training_data(
    reynolds_numbers: Iterable[float] = DEFAULT_REYNOLDS,
    mesh_sizes: Iterable[int] = DEFAULT_MESH_SIZES,
    output_dir: str = "results",
    double_lid: bool = True,
    dt: float = 1e-3,
    scheme: str = "QUICK",
    combined_name: Optional[str] = None,
    use_device_mesh: bool = False,
    spmd_devices: int = 1,
    verbose: bool = True,
    **kw,
) -> str:
    """Full sweep -> per-Re HDF5 files + one combined file (the reference's
    `results/simulation_result_double_lid.h5` layout, data notebook cell 2).
    Returns the combined file path. Each mesh size is isolated, so one
    failing size does not end the sweep (the reference wraps each case in
    try/except). `kw` goes to `batched_cavity_solve` (`device` among it).

    `use_device_mesh` shards the cases over the ranks of the process group
    (`make_mesh()`); `spmd_devices=M > 1` decomposes each case's grid M ways
    while cases shard over the remaining ranks (the 2-D ('case', 'x') mesh,
    `parallel/spmd_batch.py`). Mesh sizes not divisible by M, a mesh that
    would leave ranks idle, or a decomposed path that cannot run, fall back
    to the case-parallel path with a printed notice. Every rank makes the
    call; rank 0 writes."""
    from ..parallel.mesh import is_rank0, make_mesh, world_size

    os.makedirs(output_dir, exist_ok=True)
    bc_label = (
        "double_lid(u_top=1,u_bottom=1)" if double_lid else "lid_driven_cavity"
    )
    case_name = (
        "double lid driven cavity" if double_lid else "lid driven cavity"
    )
    if combined_name is None:
        combined_name = (
            "simulation_result_double_lid.h5" if double_lid
            else "simulation_result_single_lid.h5"
        )
    combined_path = os.path.join(output_dir, combined_name)
    mesh_devices = make_mesh() if use_device_mesh else None

    res_list = list(reynolds_numbers)
    for size in mesh_sizes:
        try:
            fields = None
            if spmd_devices > 1 and size % spmd_devices == 0:
                from ..parallel.spmd_batch import (
                    batched_spmd_cavity_solve,
                    make_case_x_mesh,
                )

                n_case = max(1, world_size() // spmd_devices)
                while len(res_list) % n_case != 0:
                    n_case -= 1
                try:
                    if n_case * spmd_devices < world_size():
                        # JAX leaves such devices idle; a rank outside the
                        # mesh would fall into the case-parallel path's
                        # collectives alone, so every rank refuses alike
                        raise ValueError(
                            f"a {n_case}x{spmd_devices} case-x mesh leaves "
                            f"{world_size() - n_case * spmd_devices} of the "
                            f"{world_size()} ranks idle")
                    fields, iters = batched_spmd_cavity_solve(
                        res_list, size, size,
                        make_case_x_mesh(n_case, spmd_devices),
                        dt=dt, scheme=scheme, double_lid=double_lid,
                        verbose=verbose, **kw,
                    )
                except ValueError as e:
                    # refusals (too few ranks, settings the decomposed path
                    # refuses) come before any solve: run case-parallel
                    # rather than drop the mesh size from the dataset
                    if verbose:
                        print(f"  mesh {size}x{size}: decomposed path "
                              f"unavailable ({e}) - running case-parallel")
                except Exception as e:  # noqa: BLE001
                    fields = None
                    print(f"  mesh {size}x{size}: decomposed solve FAILED "
                          f"({type(e).__name__}: {e}) - retrying "
                          f"case-parallel")
            elif spmd_devices > 1 and verbose:
                print(f"  mesh {size}x{size}: nx % {spmd_devices} != 0"
                      " - running case-parallel (no decomposition)")
            if fields is None:
                fields, iters = batched_cavity_solve(
                    res_list, size, size, dt=dt, scheme=scheme,
                    double_lid=double_lid, mesh_devices=mesh_devices,
                    verbose=verbose, **kw,
                )
        except Exception as e:  # noqa: BLE001 -- per-size error isolation
            print(f"  sweep error for mesh {size}x{size}: {e}")
            continue
        if not is_rank0():
            continue
        mesh = MeshParameters(nx=size, ny=size, lx=1.0, ly=1.0)
        for re_val, f in fields.items():
            re_dir = os.path.join(output_dir, f"Re{fmt_re(re_val)}")
            per_case = os.path.join(
                re_dir, f"cavity_Re{fmt_re(re_val)}_mesh{size}x{size}.h5"
            )
            for path in (per_case, combined_path):
                save_fields_hdf5(
                    path, f, mesh, re_val, case_name=case_name,
                    bc_type=bc_label,
                )
        if verbose:
            print(f"  mesh {size}x{size}: saved {len(fields)} cases "
                  f"(iterations {iters.min()}..{iters.max()})")
    return combined_path
