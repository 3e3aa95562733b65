"""Run the port's row-decomposed solver on several gloo ranks on the CPU.

`run_ranks(tmp_dir, world, cases)` spawns `world` processes (the `spawn`
start method: JAX's threads make `fork` unsafe in the test process), joins
them through a `FileStore` in `tmp_dir` (no TCP ports), runs each case
function of this module on every rank and returns rank 0's results. Every
join has its own timeout; a rank's traceback is written to `tmp_dir` and
raised in the parent. This module imports no JAX, so the ranks show that
the port runs without it.
"""

import os
import pickle
import traceback

import numpy as np
import torch

JOIN_TIMEOUT = 240  # seconds, for each rank's join


def solve_case(maker, kw):
    """SpmdSolver on the port's case `maker(**kw)` (a name in
    `solver/cases.py`), solved; with the inner counts of every step run."""
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.solver import cases

    solver = SpmdSolver(getattr(cases, maker)(device="cpu", **kw).case, device="cpu")
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


def warm_solve_save(maker, kw, fields, count, out_base):
    """SpmdSolver warm-started from (ny, nx) `fields` at `count`, solved,
    its `.dat` pair written (rank 0) under `out_base`: (count, interior
    fields)."""
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.solver import cases

    solver = SpmdSolver(getattr(cases, maker)(device="cpu", **kw).case, device="cpu")
    solver.warm_start(fields, count=count)
    solver.solve()
    solver.save_results(out_base)
    return solver.local.count, solver.interior_fields()


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


def _worker(rank, world, store, out_dir, cases):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        results = {name: globals()[fn](**kw) for name, (fn, kw) in cases.items()}
        dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(tmp_dir, world, cases):
    """{case name: rank 0's result} of `cases` ({name: (function name in
    this module, kwargs)}) run on `world` gloo ranks."""
    import multiprocessing as mp

    tmp_dir = str(tmp_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, os.path.join(tmp_dir, "store"), tmp_dir, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = sorted(n for n in os.listdir(tmp_dir) if n.startswith("error"))
    if errors:
        with open(os.path.join(tmp_dir, errors[0])) as f:
            raise RuntimeError(f"{errors[0]}:\n{f.read()}")
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited with {codes} (a join timed out after "
                           f"{JOIN_TIMEOUT} s, or a rank was killed)")
    with open(os.path.join(tmp_dir, "results.pkl"), "rb") as f:
        return pickle.load(f)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
