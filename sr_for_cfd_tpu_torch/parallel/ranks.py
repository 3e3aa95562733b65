"""Run a function on n gloo ranks on the CPU, each rank a child process.

`run_in_ranks(fn, n, *args)` starts n processes with the `forkserver`
start method (they fork from a server process that imported this module
and `fn`'s module once, so no CUDA state and no threads of the caller reach
them), joins them into one gloo process group through a `FileStore` in a
directory (no TCP ports), calls `fn(*args)` on every rank and returns rank
0's result. Every rank's join has its own timeout; a rank's traceback is
written to the directory and raised in the caller.

The planner runs its census this way (NCCL takes one rank a card), and the
CPU tests run their multi-rank cases on it.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import traceback

import torch


def _rank_main(rank: int, n: int, tmp: str, fn, args) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
                                rank=rank, world_size=n)
        result = fn(*args)
        dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_in_ranks(fn, n: int, *args, timeout: float = 600.0, tmp_dir=None):
    """Rank 0's `fn(*args)` with `fn` (a module-level function) called on
    each of n gloo ranks. `tmp_dir` holds the store, the result and the
    ranks' tracebacks (default: a temporary directory, removed after)."""
    import multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="srcfd_ranks_") if tmp_dir is None else str(tmp_dir)
    os.makedirs(tmp, exist_ok=True)
    try:
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload([__name__, fn.__module__])
        procs = [ctx.Process(target=_rank_main, args=(r, n, tmp, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = sorted(f for f in os.listdir(tmp) if f.startswith("error"))
        if errors:
            with open(os.path.join(tmp, errors[0])) as f:
                raise RuntimeError(f"{fn.__name__} on {n} ranks, {errors[0]}:\n{f.read()}")
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"{fn.__name__} on {n} ranks: exit codes {codes} (a rank "
                               f"was killed or outlived its {timeout} s join)")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        if tmp_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
