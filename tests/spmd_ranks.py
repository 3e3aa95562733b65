"""Run the port's row-decomposed solver on several gloo ranks on the CPU.

`run_ranks(tmp_dir, world, cases)` runs each case function of this module
on `world` gloo ranks through the package's launcher
(`sr_for_cfd_tpu_torch.parallel.ranks.run_in_ranks`: forkserver children
that never see the test process's JAX threads, a `FileStore` in `tmp_dir`,
a timeout for each rank's join, a rank's traceback raised in the parent)
and returns rank 0's results. This module imports no JAX, so the ranks
show that the port runs without it.
"""

import numpy as np
import torch

JOIN_TIMEOUT = 240  # seconds, for each rank's join


def solve_case(maker, kw, group=None):
    """SpmdSolver on the port's case `maker(**kw)` (a name in
    `solver/cases.py`) over `group` (default: every rank), solved; with the
    inner counts of every step run."""
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.solver import cases

    solver = SpmdSolver(getattr(cases, maker)(device="cpu", **kw).case, group, device="cpu")
    per_step = []
    step = solver._step

    def recorded(s, nu):
        s, counts = step(s, nu)
        per_step.append({k: int(v) for k, v in counts.items()})
        return s, counts

    solver._step = recorded
    solver.solve()
    out = dict(count=solver.local.count, fields=solver.global_fields(),
               inner=dict(solver.inner_counts), per_step=per_step)
    if solver._rre_stage is not None:
        out["rre_taken"] = solver._rre_stage.taken
    return out


def warm_solve_save(maker, kw, fields, count, out_base, group=None):
    """SpmdSolver over `group` (default: every rank) warm-started from
    (ny, nx) `fields` at `count`, solved, its `.dat` pair written (rank 0)
    under `out_base`: (count, interior fields)."""
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.solver import cases

    solver = SpmdSolver(getattr(cases, maker)(device="cpu", **kw).case, group,
                        device="cpu")
    solver.warm_start(fields, count=count)
    solver.solve()
    solver.save_results(out_base)
    return solver.local.count, solver.interior_fields()


def one_rank(cases):
    """Each of `cases` ({name: (function name, kwargs)}, functions that
    take `group`) on a gloo group of rank 0 alone: a one-rank world inside
    the spawn. The other ranks only join the group's creation (None)."""
    import torch.distributed as dist

    group = dist.new_group([0])
    if dist.get_rank() != 0:
        return None
    return {name: globals()[fn](group=group, **kw) for name, (fn, kw) in cases.items()}


def halo_pressure(p, ff, kw):
    """`halo.shardmap_solve_pressure` on whole numpy inputs."""
    from sr_for_cfd_tpu_torch.ops.stencil import FaceFluxes
    from sr_for_cfd_tpu_torch.parallel.halo import shardmap_solve_pressure

    out = shardmap_solve_pressure(torch.as_tensor(p),
                                  FaceFluxes(*(torch.as_tensor(f) for f in ff)), **kw)
    return out.numpy()


def mg_solve(x, b, plan_args, kw):
    """The sharded V-cycle on whole (nx, ny) numpy x and b: (x, cycles)."""
    from sr_for_cfd_tpu_torch.parallel import mesh
    from sr_for_cfd_tpu_torch.parallel.spmd_mg import make_spmd_mg_solve, plan_spmd_mg

    n, rank = mesh.size_of(), mesh.rank_of()
    rows = x.shape[0] // n
    plan = plan_spmd_mg(*plan_args, n_dev=n, dtype=x.dtype)
    x_t, b_t = (torch.as_tensor(a[rank * rows:(rank + 1) * rows]) for a in (x, b))
    solve = make_spmd_mg_solve(plan, dtype=x_t.dtype, device=x_t.device, **kw)
    out, cycles = solve(x_t, b_t)
    return mesh.all_gather(out).numpy(), cycles


def hybrid(kw):
    """`run_hybrid_experiment(**kw)` on the CPU (spmd_devices in kw): the
    iterations of each phase and the three phases' whole fields."""
    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    res = run_hybrid_experiment(device="cpu", **kw)
    return dict(iterations=[res[f"{p}_iterations"] for p in ("coarse", "ml", "normal")],
                fields={p: s.Var for p, s in res["solvers"].items()})


def warm_fine(fields, kw):
    """`run_fine_simulation_with_ml_init` from the (ny, nx) `fields` on the
    CPU (spmd_devices in kw): (iterations, whole fields)."""
    from sr_for_cfd_tpu_torch.workflow.hybrid import run_fine_simulation_with_ml_init

    solver, iterations, _ = run_fine_simulation_with_ml_init(
        ml_initial_fields=fields, device="cpu", **kw)
    return iterations, solver.Var


def cli(argv):
    """`cli.main(argv)`'s standard output on this rank, with matplotlib
    blocked (the plots' skip lines instead of the plots)."""
    import contextlib
    import io
    import sys

    from sr_for_cfd_tpu_torch import cli as tcli

    buf = io.StringIO()
    saved = sys.modules.get("matplotlib")
    sys.modules["matplotlib"] = None
    try:
        with contextlib.redirect_stdout(buf):
            tcli.main(argv)
    finally:
        if saved is None:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = saved
    return buf.getvalue()


def batched_spmd(n_case, n_x, reynolds, n, kw):
    """`batched_spmd_cavity_solve` on an n_case x n_x mesh: (fields, counts)."""
    from sr_for_cfd_tpu_torch.parallel.spmd_batch import (
        batched_spmd_cavity_solve,
        make_case_x_mesh,
    )

    return batched_spmd_cavity_solve(reynolds, n, n, make_case_x_mesh(n_case, n_x),
                                     device="cpu", verbose=False, **kw)


def sweep_over_ranks(reynolds, n, kw):
    """`batched_cavity_solve` with the cases split over every rank."""
    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.workflow.sweep import batched_cavity_solve

    return batched_cavity_solve(reynolds, n, n, mesh_devices=make_mesh(), device="cpu",
                                verbose=False, **kw)


def sweep_files(out_dir, reynolds, sizes, kw):
    """`generate_training_data(**kw)` on the CPU: the combined file's path
    and what this rank printed."""
    import contextlib
    import io

    from sr_for_cfd_tpu_torch.workflow.sweep import generate_training_data

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        path = generate_training_data(reynolds, sizes, output_dir=out_dir, device="cpu",
                                      **kw)
    return path, buf.getvalue()


def shardings(n):
    """Every rank's block of a leading axis of `n` under `batch_sharding`
    and `replicated` on the mesh over all ranks: [(start, stop) of each
    rank] for each, in rank order."""
    from sr_for_cfd_tpu_torch.parallel import mesh

    whole = mesh.make_mesh()
    out = []
    for sharding in (mesh.batch_sharding(whole), mesh.replicated(whole)):
        block = sharding.block(n)
        mine = torch.tensor([[block.start, block.stop]], dtype=torch.int64)
        out.append([tuple(r) for r in mesh.all_gather(mine).tolist()])
    return out


def dp_fit(state, x_lr, x_hr, kw):
    """Data-parallel `_fit` over every rank from the weights `state`: (the
    loss history, the kept weights, whether every rank kept the same)."""
    from sr_for_cfd_tpu_torch.models.autoencoder import SuperResolutionAE
    from sr_for_cfd_tpu_torch.parallel import mesh
    from sr_for_cfd_tpu_torch.workflow.training import _fit

    module = SuperResolutionAE(x_lr.shape[1], x_hr.shape[1])
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    out = _fit(module, x_lr, x_hr, device="cpu", mesh=mesh.make_mesh(), **kw)
    flat = torch.cat([v.reshape(-1) for v in out.params.values()])
    gathered = mesh.all_gather(flat.unsqueeze(0)).reshape(mesh.size_of(), -1)
    same = bool(torch.equal(gathered, flat.expand_as(gathered)))
    return out.loss_history, {k: v.numpy() for k, v in out.params.items()}, same


def sharded_solve(maker, kw, max_chunks=None):
    """ShardedSolver on the port's case `maker(**kw)` over `make_mesh(n,
    "x")` of every rank, solved: (count, the gathered state's padded u, v,
    p), the bands it split the rows into, the counts of its residual
    history, and this rank's calls of row 9's wrapper."""
    from sr_for_cfd_tpu_torch.parallel import spmd_kernels
    from sr_for_cfd_tpu_torch.parallel.domain import ShardedSolver
    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.solver import cases

    solver = ShardedSolver(getattr(cases, maker)(device="cpu", **kw).case,
                           make_mesh(axis_name="x"), device="cpu")
    wrapper, calls = spmd_kernels.shard_rb_sweep, [0]

    def counted(*a, **k):
        calls[0] += 1
        return wrapper(*a, **k)

    spmd_kernels.shard_rb_sweep = counted
    try:
        state = solver.solve(max_chunks=max_chunks)
    finally:
        spmd_kernels.shard_rb_sweep = wrapper
    return dict(count=state.count, fields={k: getattr(state, k).numpy() for k in "uvp"},
                bands=solver.bands, history=list(solver.residual_history.iterations),
                row9_calls=calls[0])


def chunk_census(maker, kw):
    """The port's `spmd_chunk_census` of `maker(**kw)` on every rank."""
    from sr_for_cfd_tpu_torch.parallel.comm_budget import spmd_chunk_census
    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.solver import cases

    return spmd_chunk_census(getattr(cases, maker)(device="cpu", **kw).case,
                             make_mesh(axis_name="x"), device="cpu")


def _run_cases(cases):
    return {name: globals()[fn](**kw) for name, (fn, kw) in cases.items()}


def run_ranks(tmp_dir, world, cases):
    """{case name: rank 0's result} of `cases` ({name: (function name in
    this module, kwargs)}) run on `world` gloo ranks."""
    from sr_for_cfd_tpu_torch.parallel.ranks import run_in_ranks

    return run_in_ranks(_run_cases, world, cases, timeout=JOIN_TIMEOUT, tmp_dir=tmp_dir)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
