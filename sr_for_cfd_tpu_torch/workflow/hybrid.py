"""Hybrid ML-accelerated CFD workflow (counterpart of `sr_for_cfd_tpu/workflow/hybrid.py`).

coarse solve -> super-resolve -> warm-started fine solve, plus the
cold-start baseline and the centerline comparison. Every phase runs on
`device` ("cuda" unless the caller asks for the CPU).

Differences from the JAX package:
* `save_results=False` writes nothing and creates no directory; the
  centerline difference stats are computed either way, without
  matplotlib. The comparison plot, the HDF5 group and the PNGs of a run
  are not ported yet (ROADMAP queue A, item A8); `save_results=True`
  writes each phase's .dat artifacts.
* Fine phases with `spmd_devices > 1` raise `NotImplementedError`: the
  JAX package runs them on its `SpmdSolver` behind `SpmdWorkflowAdapter`,
  which is not ported yet (ROADMAP queue A, item A11).
* The SR model comes from a Flax msgpack checkpoint (`model_file`), an
  explicit `model`, or the bicubic fallback; the split Keras .h5
  encoder/decoder convention is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import BoundaryConditions
from ..io.datfiles import extract_centerlines
from ..solver.cases import make_bfs_solver, make_cavity_solver
from ..solver.simple import CFDSolver
from ..sr.inference import BicubicSR, SRModel, ml_super_resolution
from ..utils.naming import (
    coarse_run_name,
    create_timestamped_output_dir,
    fine_run_name,
)
from ..utils.timing import trace_annotation


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
    if kw.get("spmd_devices", 1) > 1:
        raise NotImplementedError(
            "not ported to the PyTorch package yet: fine phases with "
            "spmd_devices>1 (the row-decomposed SpmdSolver behind the "
            "workflow, SpmdWorkflowAdapter: ROADMAP queue A, item A11)")
    if case == "bfs":
        return make_bfs_solver(
            Re=Re, nx=nx, ny=ny, dt=dt, scheme=scheme,
            convergence_criteria=convergence_criteria,
            max_iterations=max_iterations, bc=bc, device=device, **kw)
    return make_cavity_solver(
        Re=Re, nx=nx, ny=ny, dt=dt, scheme=scheme,
        convergence_criteria=convergence_criteria,
        max_iterations=max_iterations, bc=bc,
        double_lid=(case == "double_lid"), device=device, **kw)


def centerline_diff_stats(ml: Dict[str, np.ndarray],
                          normal: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """max / mean / rms absolute differences of the two centerlines (the
    numbers `plot_centerline_comparison` returns in the JAX package)."""
    stats = {}
    for key, name in (("u_centerline", "U"), ("v_centerline", "V")):
        diff = np.abs(np.asarray(ml[key]) - np.asarray(normal[key]))
        stats[name] = {
            "max": float(diff.max()),
            "mean": float(diff.mean()),
            "rms": float(np.sqrt((diff ** 2).mean())),
        }
    return stats


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
    model_file: Optional[str] = None,
    model=None,
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
    warm-started fine solve. Model resolution order: explicit `model` >
    `model_file` (Flax msgpack) > bicubic fallback."""
    if hr_dim is None:
        hr_dim = max(nx, ny)
    if model is None:
        if model_file and os.path.exists(model_file):
            model = SRModel.from_checkpoint(model_file, lr_dim, hr_dim, device)
        else:
            if model_file and verbose:
                print("  model checkpoint not found -> bicubic fallback")
            model = BicubicSR(lr_dim, hr_dim)

    stats = None
    if stats_file is None or not os.path.exists(stats_file):
        if not isinstance(model, BicubicSR):
            raise FileNotFoundError(
                f"Standardization stats file not found: {stats_file}")
        # the fallback is scale-free: identity stats
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
    kernel launches and RRE jumps of each phase under "kernel_launches"."""
    if save_results:
        if output_dir is None:
            output_dir = create_timestamped_output_dir()
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
                save_results=save_results, device=device, **coarse_kw)

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
    speedup = normal_time / ml_time if ml_time > 0 else float("inf")
    ms_per_iter = {
        phase: round(1e3 * t / n, 4) if n else None
        for phase, t, n in (("coarse", coarse_time, coarse_iters),
                            ("ml", ml_time, ml_iters),
                            ("normal", normal_time, normal_iters))
    }
    if verbose:
        for name, s in diff_stats.items():
            print(f"  {name} centerline diff: max={s['max']:.6e} "
                  f"mean={s['mean']:.6e} rms={s['rms']:.6e}")
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
