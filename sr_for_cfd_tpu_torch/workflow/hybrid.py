"""Hybrid ML-accelerated CFD workflow (counterpart of `sr_for_cfd_tpu/workflow/hybrid.py`).

coarse solve -> super-resolve -> warm-started fine solve, plus the
cold-start baseline and the centerline comparison. Every phase runs on
`device` ("cuda" unless the caller asks for the CPU).

Differences from the JAX package:
* `save_results=False` writes nothing and creates no directory; the
  centerline difference stats are computed either way. `save_results=True`
  writes each phase's artifact suite (`io/results.save_all_results`) and
  the warm-vs-cold centerline comparison plot; where h5py or matplotlib is
  not installed, those writers print a skip line and the .dat files are
  still written.
* Fine phases with `spmd_devices=N > 1` run row-decomposed on
  `parallel.spmd_step.SpmdSolver` behind `SpmdWorkflowAdapter`, over the
  first N ranks of the process group (`torchrun --nproc-per-node N`, one
  card or one CPU process a rank), as the JAX package runs them over N
  devices. Every rank runs the same call: the coarse phase and the SR are
  repeated on each rank, the fine phases are decomposed, and only rank 0
  prints and writes files (rank 0's output directory is every rank's).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import BoundaryConditions
from ..io.datfiles import extract_centerlines
from ..io.results import run_or_skip
from ..solver.cases import make_bfs_solver, make_cavity_solver
from ..solver.simple import CFDSolver
from ..sr.inference import BicubicSR, SRModel, ml_super_resolution
from ..utils.naming import (
    coarse_run_name,
    create_timestamped_output_dir,
    default_model_files,
    fine_run_name,
    fmt_re,
)
from ..utils.timing import trace_annotation
from ..viz.plots import (
    centerline_diff_stats,
    format_bc_summary,
    plot_centerline_comparison,
    print_diff_stats,
)


def kernel_launch_counts() -> Dict[str, int]:
    """Launch counters of the CUDA kernel wrappers (kernels run, a graph
    replay counting its kernels), the SOR wrapper's calls by route, the
    V-cycle graphs' replays, the tiled loops' sweeps and host reads of
    their device state, the fused step's calls and momentum host reads
    (its batched design (a) launches are counted in `fused_step` too, and
    alone in `fused_step_batched`), and the RRE jumps attempted and
    taken."""
    from ..ops import stream_kernels as sk
    from ..ops.extrapolate import rre_extrapolate
    from ..ops.mg_kernels import mg_solve_pressure_kernel
    from ..ops.momentum_kernels import tiled_solve_momentum
    from ..ops.pressure_kernels import solve_pressure_kernel
    from ..ops.step_kernels import simple_step_kernel, simple_step_small_batched
    from ..ops.tiled_kernels import tiled_solve_pressure
    from ..parallel.spmd_kernels import shard_rb_sweep

    return {"rb_sor_pressure": solve_pressure_kernel.launches,
            **{f"rb_sor_{k}_calls": v for k, v in solve_pressure_kernel.routes.items()},
            "mg_vcycle_pressure": mg_solve_pressure_kernel.launches,
            "fused_step": simple_step_kernel.launches,
            "fused_step_reads": simple_step_kernel.reads,
            "fused_step_calls": simple_step_kernel.calls,
            "fused_step_batched": simple_step_small_batched.launches,
            "tiled_momentum": tiled_solve_momentum.launches,
            "tiled_momentum_sweeps": tiled_solve_momentum.sweeps,
            "tiled_momentum_reads": tiled_solve_momentum.reads,
            "stream_pass_a": sk.stream_pass_a.launches,
            "stream_level1": sk.level1_correction.launches,
            "mg_vcycle_replays": mg_solve_pressure_kernel.replays,
            "stream_level1_replays": sk.level1_correction.replays,
            "stream_pass_b": sk.stream_pass_b.launches,
            "tiled_rb_pressure": tiled_solve_pressure.launches,
            "tiled_rb_sweeps": tiled_solve_pressure.sweeps,
            "tiled_rb_reads": tiled_solve_pressure.reads,
            "shard_rb_pressure": shard_rb_sweep.launches,
            "rre_attempts": rre_extrapolate.attempts,
            "rre_taken": rre_extrapolate.taken}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launch_counts().items()}


def _make_solver(case: str, Re: float, nx: int, ny: int, dt: float,
                 scheme: str, convergence_criteria, max_iterations: int,
                 bc: Optional[BoundaryConditions], device, **kw) -> CFDSolver:
    if case == "bfs":
        solver = make_bfs_solver(
            Re=Re, nx=nx, ny=ny, dt=dt, scheme=scheme,
            convergence_criteria=convergence_criteria,
            max_iterations=max_iterations, bc=bc, device=device, **kw)
    else:
        solver = make_cavity_solver(
            Re=Re, nx=nx, ny=ny, dt=dt, scheme=scheme,
            convergence_criteria=convergence_criteria,
            max_iterations=max_iterations, bc=bc,
            double_lid=(case == "double_lid"), device=device, **kw)
    if kw.get("spmd_devices", 1) > 1:
        from ..parallel.mesh import make_mesh

        return _decomposed(solver, make_mesh(kw["spmd_devices"], "x"), device)
    return solver


def _decomposed(solver: CFDSolver, mesh, device):
    """`solver`'s case row-decomposed over the 'x' axis of `mesh`, behind
    the surface the workflow drives (a fine phase with spmd_devices > 1)."""
    from ..parallel.spmd_step import SpmdSolver, SpmdWorkflowAdapter

    return SpmdWorkflowAdapter(SpmdSolver(solver.case, mesh, device=device))


def _rank0_output_dir(output_dir: Optional[str], save_results: bool) -> Optional[str]:
    """The run directory of a decomposed run: rank 0's, made there and
    sent to every rank."""
    import torch.distributed as dist

    from ..parallel.mesh import is_rank0

    if save_results and output_dir is None and is_rank0():
        output_dir = create_timestamped_output_dir()
    if dist.is_initialized():
        box = [output_dir]
        dist.broadcast_object_list(box, src=0)
        output_dir = box[0]
    return output_dir


def run_coarse_simulation(
    Re: float,
    lr_dim: int = 10,
    dt: float = 0.001,
    scheme: str = "QUICK",
    convergence_criteria: Optional[Dict[str, float]] = None,
    max_iterations: int = 100000,
    output_dir: Optional[str] = None,
    bc: Optional[BoundaryConditions] = None,
    case: str = "cavity",
    verbose: bool = True,
    save_results: bool = True,
    device="cuda",
    **kw,
) -> Tuple[Dict[str, np.ndarray], CFDSolver, int, float]:
    """Step 1: coarse lr_dim x lr_dim solve; returns the interior fields
    transposed to (ny, nx)."""
    prefix = "bfs_" if case == "bfs" else ""
    output_name = coarse_run_name(output_dir or ".", prefix, Re, lr_dim,
                                  max_iterations)
    solver = _make_solver(case, Re, lr_dim, lr_dim, dt, scheme,
                          convergence_criteria, max_iterations, bc, device, **kw)
    solver.precompile()
    iterations, elapsed = solver.solve(output_name, verbose=verbose,
                                       save_results=save_results)
    return solver.interior_fields(), solver, iterations, elapsed


def generate_coarse_mesh_solution(
    Re: float, lr_dim: int = 10, output_dir: Optional[str] = None, **kw
) -> Tuple[Dict[str, np.ndarray], Optional[str]]:
    """Wrapper: timestamped dir + coarse run
    (`PyCFD_ML_accelerated.py:966-1021`). With `save_results=False` no
    directory is made and the returned one is `output_dir` as given."""
    if output_dir is None and kw.get("save_results", True):
        output_dir = create_timestamped_output_dir()
    fields, _, _, _ = run_coarse_simulation(
        Re, lr_dim=lr_dim, output_dir=output_dir, **kw
    )
    return fields, output_dir


def run_fine_simulation_with_ml_init(
    Re: float, nx: int, ny: int, ml_initial_fields: Dict[str, np.ndarray],
    dt: float = 0.001, scheme: str = "QUICK",
    convergence_criteria: Optional[Dict[str, float]] = None,
    max_iterations: int = 100000, output_name: str = "cavity_accelerated",
    bc: Optional[BoundaryConditions] = None, case: str = "cavity",
    verbose: bool = True, save_results: bool = True, device="cuda", **kw,
) -> Tuple[CFDSolver, int, float]:
    """Step 3: fine solve warm-started from the (ny, nx) ML fields."""
    solver = _make_solver(case, Re, nx, ny, dt, scheme, convergence_criteria,
                          max_iterations, bc, device, **kw)
    solver.warm_start(ml_initial_fields)
    if not output_name.endswith("_accelerated"):
        output_name = f"{output_name}_accelerated"
    solver.precompile()
    iterations, elapsed = solver.solve(output_name, verbose=verbose,
                                       save_results=save_results)
    return solver, iterations, elapsed


def run_normal_simulation(
    Re: float, nx: int, ny: int, dt: float = 0.001, scheme: str = "QUICK",
    convergence_criteria: Optional[Dict[str, float]] = None,
    max_iterations: int = 100000, output_name: str = "cavity_normal",
    bc: Optional[BoundaryConditions] = None, case: str = "cavity",
    verbose: bool = True, save_results: bool = True, device="cuda", **kw,
) -> Tuple[CFDSolver, int, float]:
    """Cold-start fine solve: the comparison baseline."""
    solver = _make_solver(case, Re, nx, ny, dt, scheme, convergence_criteria,
                          max_iterations, bc, device, **kw)
    if not output_name.endswith("_normal"):
        output_name = f"{output_name}_normal"
    solver.precompile()
    iterations, elapsed = solver.solve(output_name, verbose=verbose,
                                       save_results=save_results)
    return solver, iterations, elapsed


def run_ml_accelerated_fine_simulation(
    Re: float,
    nx: int,
    ny: int,
    coarse_fields: Dict[str, np.ndarray],
    lr_dim: int = 10,
    hr_dim: Optional[int] = None,
    stats_file: Optional[str] = None,
    encoder_file: Optional[str] = None,
    decoder_file: Optional[str] = None,
    model_file: Optional[str] = None,
    model=None,
    model_suffix: str = "swish_trained_upto_700_multiBC",
    model_dir: str = ".",
    use_aspect_ratio_correction: bool = False,
    lx: float = 1.0,
    ly: float = 1.0,
    use_adaptive_normalization: bool = False,
    blend_factor: float = 0.3,
    output_name: str = "cavity_ml",
    case: str = "cavity",
    verbose: bool = True,
    device="cuda",
    **kw,
) -> Tuple[CFDSolver, int, float, Dict[str, np.ndarray]]:
    """Step 2+3: super-resolve the coarse fields, then run the
    warm-started fine solve (`PyCFD_ML_accelerated.py:1024-1119`).

    Model resolution order, as in the JAX package: explicit `model` >
    `model_file` (Flax msgpack) if it exists > the split encoder/decoder
    parts (`encoder_file`, `decoder_file`, else the reference's names in
    `model_dir` for `model_suffix`, `utils.naming.default_model_files`) if
    both exist > bicubic fallback. `stats_file` defaults to the reference's
    name in `model_dir`; a trained model without it raises."""
    if hr_dim is None:
        hr_dim = max(nx, ny)
    names = default_model_files(lr_dim, hr_dim, model_suffix, model_dir)
    if stats_file is None:
        stats_file = names["stats_file"]

    if model is None:
        if encoder_file is None and os.path.exists(names["encoder_file"]):
            encoder_file = names["encoder_file"]
        if decoder_file is None and os.path.exists(names["decoder_file"]):
            decoder_file = names["decoder_file"]
        if model_file and os.path.exists(model_file):
            model = SRModel.from_checkpoint(model_file, lr_dim, hr_dim, device)
        elif (encoder_file and decoder_file
              and os.path.exists(encoder_file) and os.path.exists(decoder_file)):
            model = SRModel.from_parts(encoder_file, decoder_file, lr_dim,
                                       hr_dim, device=device)
        else:
            if (model_file or encoder_file) and verbose:
                print("  model checkpoint(s) not found -> bicubic fallback")
            model = BicubicSR(lr_dim, hr_dim)

    stats = None
    if not os.path.exists(stats_file):
        if not isinstance(model, BicubicSR):
            raise FileNotFoundError(
                f"Standardization stats file not found: {stats_file}")
        # the fallback is scale-free: identity stats
        if verbose:
            print(f"  stats file not found ({stats_file}) -> identity "
                  "standardization (bicubic fallback is scale-free)")
        stats = {f"{k}{d}_{c}": float(k == "std")
                 for k in ("mean", "std") for d in (lr_dim, hr_dim)
                 for c in ("u", "v", "p")}
        stats_file = None

    hr_fields = ml_super_resolution(
        coarse_fields, lr_dim, hr_dim, stats=stats, stats_file=stats_file,
        model=model, use_aspect_ratio_correction=use_aspect_ratio_correction,
        lx=lx, ly=ly, use_adaptive_normalization=use_adaptive_normalization,
        blend_factor=blend_factor, out_shape=(ny, nx), verbose=verbose,
        device=device,
    )
    solver, iterations, elapsed = run_fine_simulation_with_ml_init(
        Re, nx, ny, hr_fields, output_name=output_name, case=case,
        verbose=verbose, device=device, **kw,
    )
    return solver, iterations, elapsed, hr_fields


def run_hybrid_experiment(
    Re: float = 1000,
    lr_dim: int = 10,
    hr_dim: int = 400,
    dt: Optional[float] = None,
    scheme: Optional[str] = None,
    case: str = "cavity",
    max_iterations_coarse: int = 100000,
    max_iterations_ml: int = 200,
    max_iterations_normal: int = 100000,
    stats_file: Optional[str] = None,
    model=None,
    model_file: Optional[str] = None,
    use_aspect_ratio_correction: bool = False,
    use_adaptive_normalization: bool = False,
    blend_factor: float = 0.3,
    bc: Optional[BoundaryConditions] = None,
    output_dir: Optional[str] = None,
    verbose: bool = True,
    save_results: bool = True,
    coarse_overrides: Optional[Dict] = None,
    device="cuda",
    **kw,
) -> Dict:
    """coarse -> SR -> warm-started fine (capped) vs cold-start fine, then
    the centerline comparison. Returns a results dict with the JAX
    package's keys, plus each phase's solver under "solvers" and the CUDA
    kernel launches and RRE jumps of each phase under "kernel_launches".
    With `spmd_devices > 1` every rank of the mesh makes this call; rank 0
    prints and writes (see the module docstring)."""
    decomposed = kw.get("spmd_devices", 1) > 1
    writer = True
    if decomposed:
        from ..parallel.mesh import is_rank0

        writer = is_rank0()
        verbose = verbose and writer
        output_dir = _rank0_output_dir(output_dir, save_results)
    if save_results:
        if output_dir is None:
            output_dir = create_timestamped_output_dir()
        if writer:
            os.makedirs(output_dir, exist_ok=True)
    is_bfs = case == "bfs"
    if dt is None:
        dt = 2e-3 if is_bfs else 1e-3
    if scheme is None:
        scheme = "UPWIND" if is_bfs else "QUICK"
    lx, ly = (10.0, 3.0) if is_bfs else (1.0, 1.0)
    prefix = "bfs" if is_bfs else "cavity"
    run_dir = output_dir or "."

    # coarse-phase defaults of the JAX package: plateau stopping on, the
    # whole budget as one chunk, inner sweeps capped at 256
    coarse_kw = dict(kw)
    coarse_kw.setdefault("plateau_patience", 5)
    coarse_kw.setdefault("chunk_size", max_iterations_coarse)
    coarse_kw["spmd_devices"] = 1
    coarse_kw.setdefault("inner_max_iter", 256)
    coarse_kw.update(coarse_overrides or {})

    launches = {}
    before = kernel_launch_counts()
    with trace_annotation("hybrid.coarse"):
        coarse_fields, coarse_solver, coarse_iters, coarse_time = \
            run_coarse_simulation(
                Re, lr_dim=lr_dim, dt=dt, scheme=scheme,
                max_iterations=max_iterations_coarse, output_dir=run_dir,
                bc=bc, case=case, verbose=verbose,
                save_results=save_results and writer, device=device, **coarse_kw)

    launches["coarse"] = _launches_since(before)
    before = kernel_launch_counts()
    ml_name = fine_run_name(run_dir, prefix, Re, hr_dim, hr_dim,
                            max_iterations_coarse, max_iterations_ml, "ML")
    with trace_annotation("hybrid.ml_fine"):
        ml_solver, ml_iters, ml_time, hr_fields = \
            run_ml_accelerated_fine_simulation(
                Re, hr_dim, hr_dim, coarse_fields, lr_dim=lr_dim,
                hr_dim=hr_dim, stats_file=stats_file, model=model,
                model_file=model_file,
                use_aspect_ratio_correction=use_aspect_ratio_correction,
                lx=lx, ly=ly,
                use_adaptive_normalization=use_adaptive_normalization,
                blend_factor=blend_factor, dt=dt, scheme=scheme,
                max_iterations=max_iterations_ml, output_name=ml_name, bc=bc,
                case=case, verbose=verbose, save_results=save_results,
                device=device, **kw)

    launches["ml"] = _launches_since(before)
    before = kernel_launch_counts()
    normal_name = fine_run_name(run_dir, prefix, Re, hr_dim, hr_dim, None,
                                max_iterations_normal, "NORMAL")
    with trace_annotation("hybrid.normal_fine"):
        normal_solver, normal_iters, normal_time = run_normal_simulation(
            Re, hr_dim, hr_dim, dt=dt, scheme=scheme,
            max_iterations=max_iterations_normal, output_name=normal_name,
            bc=bc, case=case, verbose=verbose, save_results=save_results,
            device=device, **kw)

    launches["normal"] = _launches_since(before)
    ml_cl = extract_centerlines(ml_solver.Var, ml_solver.mesh)
    normal_cl = extract_centerlines(normal_solver.Var, normal_solver.mesh)
    diff_stats = centerline_diff_stats(ml_cl, normal_cl)
    plotted = False
    if save_results and writer:
        plot = os.path.join(output_dir,
                            f"{prefix}_Re{fmt_re(Re)}_centerline_comparison.png")
        # the reference's BC subtitle (`format_bc_summary`); the plot
        # prints the difference stats
        plotted = run_or_skip(
            "centerline comparison plot", "matplotlib", [plot],
            lambda: plot_centerline_comparison(
                plot, ml_cl, normal_cl, Re,
                bc_summary=format_bc_summary(bc) if bc is not None else None))
    speedup = normal_time / ml_time if ml_time > 0 else float("inf")
    ms_per_iter = {
        phase: round(1e3 * t / n, 4) if n else None
        for phase, t, n in (("coarse", coarse_time, coarse_iters),
                            ("ml", ml_time, ml_iters),
                            ("normal", normal_time, normal_iters))
    }
    if verbose and not plotted:
        print_diff_stats(diff_stats)
    if verbose:
        print(f"  Coarse solve : {coarse_iters} iters, {coarse_time:.2f}s "
              f"({ms_per_iter['coarse']} ms/iter)")
        print(f"  ML fine solve: {ml_iters} iters, {ml_time:.2f}s "
              f"({ms_per_iter['ml']} ms/iter)")
        print(f"  Normal solve : {normal_iters} iters, {normal_time:.2f}s "
              f"({ms_per_iter['normal']} ms/iter)")
    return {
        "coarse_iterations": coarse_iters,
        "coarse_time": coarse_time,
        "ml_iterations": ml_iters,
        "ml_time": ml_time,
        "normal_iterations": normal_iters,
        "normal_time": normal_time,
        "ms_per_iteration": ms_per_iter,
        "speedup": speedup,
        "iterations_saved": normal_iters - ml_iters,
        "centerline_diff": diff_stats,
        "output_dir": output_dir,
        "hr_fields": hr_fields,
        "coarse_fields": coarse_fields,
        "kernel_launches": launches,
        "solvers": {"coarse": coarse_solver, "ml": ml_solver,
                    "normal": normal_solver},
    }
