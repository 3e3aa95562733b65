"""Command-line interface (counterpart of `sr_for_cfd_tpu/cli.py`).

    python -m sr_for_cfd_tpu_torch.cli <command> [options]
    srcfd-torch <command> [options]

The JAX package's subcommands, option names and defaults, with the
reference's defaults, plus `--device {cuda,cpu}` (default the card):

  cavity  - lid-driven cavity solve (single/double lid)
  bfs     - backward-facing step solve
  hybrid  - coarse -> SR -> warm-started fine vs normal (the product)
  sweep   - Re x mesh data-generation sweep -> HDF5 (needs h5py)
  train   - SR autoencoder training from sweep HDF5 (needs h5py)

`--spmd N > 1` (cavity, bfs: the row-decomposed solve; hybrid: its fine
phases) and sweep's `--device-mesh` / `--spmd M` run over the ranks of a
process group, one process a card (or a CPU process with `--device cpu`):

    torchrun --nproc-per-node 4 -m sr_for_cfd_tpu_torch.cli hybrid --spmd 4 ...

Under torchrun each rank joins the group that its environment describes
(NCCL for the card, gloo for the CPU); rank 0 prints the results and
writes the files. Not ported yet, each exiting non-zero with a message
that names its ROADMAP item: `bench` (A9's bench) and `plan` (A11).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_A9 = ("is not ported to the PyTorch package yet (the solver throughput "
       "benchmark: ROADMAP queue A, item A9, waits for a benchmark PR; the "
       "root bench.py imports jax)")
_A11 = ("is not ported to the PyTorch package yet (the decomposition "
        "planner parallel/planner.py: ROADMAP queue A, item A11)")


def _device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or the plain PyTorch "
                        "path on the CPU")


def _solver_args(p: argparse.ArgumentParser, dt: float, scheme: str):
    p.add_argument("--re", type=float, default=400)
    p.add_argument("--nx", type=int, default=100)
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--dt", type=float, default=dt)
    p.add_argument("--scheme", choices=["QUICK", "UPWIND"], default=scheme)
    p.add_argument("--max-iterations", type=int, default=100000)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--chunk-size", type=int, default=100)
    p.add_argument("--fused", action="store_true",
                   help="fused whole-step kernel (float32); combine with "
                        "--pressure-solver multigrid for the whole step + "
                        "V-cycle kernel")
    p.add_argument("--steps-per-kernel", type=int, default=1, metavar="K",
                   help="outer iterations per fused-kernel call "
                        "(requires --fused and K | chunk-size)")
    p.add_argument("--sor", type=float, default=1.0,
                   help="pressure SOR factor (1.0 = reference semantics)")
    p.add_argument("--pressure-solver", choices=["sweeps", "multigrid"],
                   default="sweeps",
                   help="'multigrid' solves each step's pressure system to "
                        "tolerance (fastest on fine grids)")
    p.add_argument("--plateau", type=int, default=0, metavar="N",
                   help="stop when residuals plateau for N chunks "
                        "(working-precision convergence for float32)")
    p.add_argument("--use-pallas", action="store_true",
                   help="the CUDA inner-solve kernels without fusing the "
                        "whole step: with --pressure-solver multigrid the "
                        "kernel is chosen by grid size (the V-cycle, then "
                        "the streamed V-cycle + tiled momentum past ~1160^2)")
    p.add_argument("--rre", type=int, default=0, metavar="W",
                   help="reduced-rank extrapolation: snapshot the state "
                        "every W iterations and jump once depth+1 "
                        "snapshots accumulate (ops/extrapolate.py)")
    p.add_argument("--rre-depth", type=int, default=6, metavar="K",
                   help="RRE window depth (snapshots per jump = K+1)")
    p.add_argument("--spmd", type=int, default=1, metavar="N",
                   help="domain-decompose the solve over N ranks, one a "
                        "device (interior rows sharded, ring halo exchange: "
                        "parallel.spmd_step.SpmdSolver; nx must divide N; "
                        "run under torchrun --nproc-per-node N). For "
                        "`hybrid` this decomposes the fine phases; the "
                        "coarse phase stays on one device")
    p.add_argument("--out", default=None, help="output base name / directory")
    p.add_argument("--quiet", action="store_true")
    _device_arg(p)


def _common_kw(args):
    return dict(
        dt=args.dt, scheme=args.scheme, max_iterations=args.max_iterations,
        dtype=args.dtype, chunk_size=args.chunk_size,
        fused_step=args.fused, pressure_sor=args.sor,
        pressure_solver=args.pressure_solver,
        plateau_patience=args.plateau,
        steps_per_kernel=args.steps_per_kernel,
        use_pallas=args.use_pallas,
        rre_every=args.rre, rre_depth=args.rre_depth,
        device=args.device,
    )


def _join_process_group(device: str) -> bool:
    """Join the process group that torchrun's environment describes (once;
    False when there is none or it is joined already): NCCL with each rank
    on the card of its LOCAL_RANK, or gloo for the CPU."""
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if device == "cuda":
        import torch

        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return True


def _check_ranks(n: int) -> None:
    """Exit unless the process group has the N ranks of `--spmd N`."""
    from .parallel.mesh import world_size

    if n > world_size():
        raise SystemExit(
            f"--spmd {n} needs {n} devices; backend has {world_size()} (one "
            f"rank per device: torchrun --nproc-per-node {n} -m "
            "sr_for_cfd_tpu_torch.cli ...)")


def _rank0_print(*a, **k):
    from .parallel.mesh import is_rank0

    if is_rank0():
        print(*a, **k)


def _run_spmd(args, make_solver, out):
    """Row-decomposed solve over --spmd ranks and the artifact suite (the
    single-device path's outputs, written by rank 0)."""
    import time

    from .parallel.mesh import make_mesh
    from .parallel.spmd_step import SpmdSolver

    _check_ranks(args.spmd)
    kw = _common_kw(args)
    kw["spmd_devices"] = args.spmd
    ny = args.ny or args.nx
    case = make_solver(Re=args.re, nx=args.nx, ny=ny, **kw).case
    solver = SpmdSolver(case, make_mesh(args.spmd, "x"), device=args.device)
    t0 = time.time()
    local = solver.solve()
    secs = time.time() - t0
    solver.save_results(out)
    _rank0_print(f"Converged in {int(local.count)} iterations ({secs:.2f} "
                 f"seconds) on {args.spmd} devices")


def cmd_cavity(args):
    from .solver.cases import create_lid_driven_cavity, make_cavity_solver

    ny = args.ny or args.nx
    out = args.out or f"cavity_Re{int(args.re)}"
    if args.spmd > 1:
        from functools import partial

        _run_spmd(args, partial(make_cavity_solver, double_lid=args.double_lid), out)
        return
    solver, iters, secs = create_lid_driven_cavity(
        Re=args.re, nx=args.nx, ny=ny, output_name=out,
        double_lid=args.double_lid, verbose=not args.quiet,
        **_common_kw(args),
    )
    print(f"Converged in {iters} iterations ({secs:.2f} seconds)")


def cmd_bfs(args):
    from .solver.cases import create_bfs_case, make_bfs_solver

    ny = args.ny or args.nx
    out = args.out or f"bfs_Re{int(args.re)}"
    if args.spmd > 1:
        _run_spmd(args, make_bfs_solver, out)
        return
    solver, iters, secs = create_bfs_case(
        Re=args.re, nx=args.nx, ny=ny, output_name=out,
        verbose=not args.quiet, **_common_kw(args),
    )
    print(f"Converged in {iters} iterations ({secs:.2f} seconds)")


def cmd_hybrid(args):
    from .workflow.hybrid import run_hybrid_experiment

    kw = dict(
        dt=args.dt, scheme=args.scheme, dtype=args.dtype,
        fused_step=args.fused, pressure_sor=args.sor,
        pressure_solver=args.pressure_solver,
        steps_per_kernel=args.steps_per_kernel,
        use_pallas=args.use_pallas,
    )
    if args.spmd > 1:
        # decompose the fine phases over N ranks (run_hybrid_experiment
        # pins the coarse phase to one device)
        _check_ranks(args.spmd)
        kw["spmd_devices"] = args.spmd
    if args.rre:
        # RRE on the coarse phase's long pseudo-time march
        kw["coarse_overrides"] = {
            "rre_every": args.rre, "rre_depth": args.rre_depth,
        }
    if args.rre_fine:
        # RRE on both fine phases (warm and cold: both sides of the
        # speedup ratio run the same solver); the cycle
        # rre_fine * (rre_depth + 1) must fit inside one chunk
        kw["rre_every"] = args.rre_fine
        kw["rre_depth"] = args.rre_depth
    # only forward the shared-solver defaults when the user changed them:
    # run_hybrid_experiment's coarse phase sets its own (plateau on, the
    # whole budget as one chunk), which unconditional forwarding would
    # override
    if args.chunk_size != 100:
        kw["chunk_size"] = args.chunk_size
    if args.plateau:
        kw["plateau_patience"] = args.plateau
    results = run_hybrid_experiment(
        Re=args.re, lr_dim=args.lr_dim, hr_dim=args.hr_dim,
        case=args.case,
        max_iterations_coarse=args.max_iterations,
        max_iterations_ml=args.ml_iterations,
        max_iterations_normal=args.normal_iterations,
        stats_file=args.stats_file, model_file=args.model_file,
        use_aspect_ratio_correction=args.case == "bfs",
        use_adaptive_normalization=args.adaptive_norm,
        blend_factor=args.blend_factor,
        output_dir=args.out, verbose=not args.quiet, device=args.device,
        **kw,
    )
    # the JAX package's keys and the kernel launches of each phase; the
    # fields and solvers stay out of the JSON
    for key in ("hr_fields", "coarse_fields", "solvers"):
        results.pop(key)
    _rank0_print(json.dumps(results, indent=2, default=str))


def cmd_sweep(args):
    from .io.hdf5 import _h5py
    from .workflow.sweep import generate_training_data

    _h5py()  # raises before any case is solved: the sweep writes HDF5
    path = generate_training_data(
        reynolds_numbers=args.re_list,
        mesh_sizes=args.mesh_sizes,
        output_dir=args.out or "results",
        double_lid=args.double_lid,
        dt=args.dt, scheme=args.scheme, dtype=args.dtype,
        max_iterations=args.max_iterations,
        use_device_mesh=args.device_mesh,
        spmd_devices=args.spmd,
        verbose=not args.quiet, device=args.device,
    )
    _rank0_print(f"Combined dataset: {path}")


def cmd_train(args):
    import numpy as np

    from .io.hdf5 import load_paired_reynolds_multi
    from .workflow import training as tr

    x_lr, x_hr, res, comps, bcs = load_paired_reynolds_multi(
        args.data, args.lr_dim, args.hr_dim
    )
    print(f"Loaded {len(x_lr)} samples "
          f"({dict(zip(*np.unique(bcs, return_counts=True)))})")
    cfg = None
    if args.test_re:
        cfg = {
            str(bc): {"train": "ALL_EXCEPT_TEST", "test": args.test_re,
                      "evaluate": args.test_re}
            for bc in np.unique(bcs)
        }
    train_mask, test_mask = tr.split_by_reynolds_config(res, bcs, cfg)
    x_lr_n, x_hr_n, stats = tr.standardize_train_test(
        x_lr, x_hr, comps, train_mask, args.lr_dim, args.hr_dim
    )
    print(f"Train {train_mask.sum()} / test {test_mask.sum()} samples")
    result = tr.train_sr_autoencoder(
        x_lr_n[train_mask], x_hr_n[train_mask], args.lr_dim, args.hr_dim,
        epochs=args.epochs, batch_size=args.batch_size, verbose=not args.quiet,
        device=args.device,
    )
    print(f"Final loss {result.loss_history[-1]:.6f} "
          f"({result.seconds:.1f}s)")
    for re_val in args.test_re or []:
        tr.evaluate_for_re(
            re_val, result.model, result.params,
            x_lr_n[test_mask], x_hr_n[test_mask], res[test_mask],
            comps[test_mask], stats, args.lr_dim, args.hr_dim,
            plot_dir=args.out if args.plots else None,
        )
    paths = tr.export_models(
        result, stats, args.lr_dim, args.hr_dim, args.suffix,
        out_dir=args.out or ".",
    )
    print(json.dumps(paths, indent=2))


def cmd_bench(args):
    raise SystemExit(f"bench {_A9}")


def cmd_plan(args):
    raise SystemExit(f"plan (the decomposition planner) {_A11}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="srcfd-torch",
        description="ML-accelerated steady-state CFD on PyTorch/CUDA "
                    "(the PyTorch port of sr_for_cfd_tpu).",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("cavity", help="lid-driven cavity solve")
    _solver_args(p, dt=1e-3, scheme="QUICK")
    p.add_argument("--double-lid", action="store_true")
    p.set_defaults(fn=cmd_cavity, re=100)

    p = sub.add_parser("bfs", help="backward-facing step solve")
    _solver_args(p, dt=2e-3, scheme="UPWIND")
    p.set_defaults(fn=cmd_bfs)

    p = sub.add_parser("hybrid", help="ML-accelerated hybrid experiment")
    # dt/scheme default to None -> run_hybrid_experiment picks the
    # per-case reference defaults (bfs: UPWIND @ 2e-3; cavity: QUICK @ 1e-3)
    _solver_args(p, dt=None, scheme=None)
    p.add_argument("--case", choices=["cavity", "double_lid", "bfs"],
                   default="cavity")
    p.add_argument("--lr-dim", type=int, default=10)
    p.add_argument("--hr-dim", type=int, default=400)
    p.add_argument("--rre-fine", type=int, default=0, metavar="W",
                   help="reduced-rank extrapolation on both fine phases "
                        "(warm and cold) at snapshot cadence W; --rre "
                        "covers the coarse phase, --rre-depth is shared")
    p.add_argument("--ml-iterations", type=int, default=200)
    p.add_argument("--normal-iterations", type=int, default=100000)
    p.add_argument("--stats-file", default=None)
    p.add_argument("--model-file", default=None)
    p.add_argument("--adaptive-norm", action="store_true")
    p.add_argument("--blend-factor", type=float, default=0.3)
    p.set_defaults(fn=cmd_hybrid, re=1000)

    p = sub.add_parser("sweep", help="data-generation sweep -> HDF5")
    p.add_argument("--re-list", type=float, nargs="+",
                   default=list(range(100, 801, 100)))
    p.add_argument("--mesh-sizes", type=int, nargs="+", default=[10, 50, 400])
    p.add_argument("--double-lid", action="store_true", default=True)
    p.add_argument("--single-lid", dest="double_lid", action="store_false")
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--scheme", default="QUICK")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--max-iterations", type=int, default=100000)
    p.add_argument("--device-mesh", action="store_true",
                   help="shard cases across the ranks of the process group")
    p.add_argument("--spmd", type=int, default=1, metavar="M",
                   help="decompose EACH case's grid over M ranks while "
                        "cases shard over the rest (2-D case-x-grid mesh, "
                        "parallel/spmd_batch.py); sizes not divisible by "
                        "M fall back to case-parallel")
    p.add_argument("--out", default="results")
    p.add_argument("--quiet", action="store_true")
    _device_arg(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("train", help="train the SR autoencoder")
    p.add_argument("data", nargs="+", help="sweep HDF5 file(s)")
    p.add_argument("--lr-dim", type=int, default=10)
    p.add_argument("--hr-dim", type=int, default=400)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--test-re", type=float, nargs="*", default=[800])
    p.add_argument("--suffix", default="swish_tpu")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--out", default="models")
    p.add_argument("--quiet", action="store_true")
    _device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("bench", help=f"solver throughput benchmark: {_A9}")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("plan", help=f"decomposition planner: {_A11}")
    p.add_argument("--case", choices=["cavity", "bfs"], default="cavity")
    p.add_argument("--re", type=float, default=1000)
    p.add_argument("--nx", type=int, default=400)
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--scheme", choices=["QUICK", "UPWIND"], default="QUICK")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--pressure-solver", choices=["sweeps", "multigrid"],
                   default="multigrid")
    p.add_argument("--use-pallas", action="store_true")
    p.add_argument("--fused", action="store_true")
    p.add_argument("--steps-per-kernel", type=int, default=1)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="candidate device counts")
    p.add_argument("--ms-per-step", type=float, default=None,
                   help="single-chip ms/step (default: measure live)")
    p.add_argument("--trip-window", type=int, default=6,
                   help="steps to measure inner-loop trip counts over")
    p.add_argument("--json", default=None, help="write the plan as JSON")
    p.add_argument("--no-subprocess", action="store_true")
    p.set_defaults(fn=cmd_plan)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    joined = _join_process_group(getattr(args, "device", "cuda"))
    try:
        return args.fn(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
