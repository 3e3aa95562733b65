"""Case-parallel x row-decomposed cavity solves on a 2-D ('case', 'x') mesh
(counterpart of `sr_for_cfd_tpu/parallel/spmd_batch.py`).

The data-generation sweep shards whole cases over ranks
(`workflow/sweep.py`), and `SpmdSolver` decomposes one case's rows over
ranks (`parallel/spmd_step.py`). This module composes the two: a batch of
same-shape cavity cases (a Reynolds number each), each decomposed over the
mesh's 'x' axis, the cases sharded over its 'case' axis (e.g. 2 x 400^2
cases, each split 4 ways, on 8 cards).

The mesh's ranks are laid out row-major: the ranks of one case row share a
process group (`dist.new_group`, every rank creating every row's group in
the same order), over which that row's cases run the row-decomposed step
of `SpmdSolver`. A rank steps its row's cases one after another inside each
chunk, each frozen once it has converged, diverged or spent its budget, so
every case follows its solo `SpmdSolver` trajectory bit for bit (JAX
vmaps the step over the cases with the same freezing). After each chunk the
ranks share every case's count and flags, so that all of them stop
together; at the end the bands are gathered to every rank.

Reference contract: the strictly sequential Re x mesh loop of
`sr-simulation-data-creation.ipynb` cell 2, composed with the prange
replacement of `LDV PyCFD given by sir.py:517-597`.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as ring
from .mesh import Mesh


def make_case_x_mesh(n_case: int, n_x: int, case_axis: str = "case",
                     x_axis: str = "x") -> Mesh:
    """2-D mesh over the first n_case * n_x ranks, with the process group of
    this rank's case row. Every rank of the default group calls it alike."""
    world = ring.world_size()
    need = n_case * n_x
    if world < need:
        raise ValueError(
            f"case-x mesh needs {n_case}x{n_x}={need} devices; backend "
            f"has {world}"
        )
    group = None if need == world else dist.new_group(list(range(need)))
    axis_groups = {}
    if n_case > 1:
        rank = dist.get_rank()
        for c in range(n_case):
            g = dist.new_group(list(range(c * n_x, (c + 1) * n_x)))
            if c * n_x <= rank < (c + 1) * n_x:
                axis_groups[x_axis] = g
    return Mesh(range(need), (case_axis, x_axis), (n_case, n_x), group, axis_groups)


def batched_spmd_cavity_solve(
    reynolds: Sequence[float],
    nx: int,
    ny: int,
    mesh: Mesh,
    *,
    dt: float = 1e-3,
    scheme: str = "QUICK",
    double_lid: bool = True,
    max_iterations: int = 100000,
    chunk_size: int = 1000,
    verbose: bool = True,
    case_axis: str = "case",
    x_axis: str = "x",
    device="cuda",
    **settings_kw,
) -> Tuple[Dict[float, Dict[str, np.ndarray]], np.ndarray]:
    """All Reynolds numbers of one cavity mesh size, cases sharded over
    `case_axis` and each case's rows decomposed over `x_axis`.

    The return contract of `workflow.sweep.batched_cavity_solve`, on every
    rank: ({Re: {u, v, p} interior (ny, nx) fields}, iterations[n]),
    diverged cases dropped with a printed notice.
    """
    from ..solver.cases import make_cavity_solver
    from .spmd_step import SpmdSolver

    res = np.asarray(list(reynolds), dtype=np.float64)
    n = len(res)
    n_case, n_x = mesh.shape[case_axis], mesh.shape[x_axis]
    if n % n_case != 0:
        raise ValueError(
            f"{n} cases do not shard over {n_case} '{case_axis}' devices"
        )
    if settings_kw.get("rre_every", 0) > 0:
        raise ValueError(
            "rre_every is not supported on the case-batched decomposed "
            "path (the snapshot buffer is per-case chunk state); use "
            "SpmdSolver for a single extrapolated decomposed solve"
        )
    if (settings_kw.get("pressure_solver", "sweeps") not in
            ("sweeps", "multigrid")
            or settings_kw.get("use_pallas")
            or settings_kw.get("fused_step")):
        raise ValueError(
            "the case-batched decomposed path runs the jnp sweeps or "
            "sharded-multigrid pressure solves (vmap carries their "
            "collectives; the Pallas kernels are single-case) - for "
            "Pallas inner solves decompose one case at a time with "
            "SpmdSolver"
        )
    settings_kw.setdefault("chunk_size", chunk_size)
    solver = make_cavity_solver(
        Re=float(res[0]), nx=nx, ny=ny, dt=dt, scheme=scheme,
        double_lid=double_lid, max_iterations=max_iterations, device=device,
        **settings_kw,
    )
    case = solver.case
    if nx % n_x != 0:
        raise ValueError(
            f"nx = {nx} must divide over {n_x} '{x_axis}' devices"
        )
    spmd = SpmdSolver(case, mesh.axis_group(x_axis), device=device)
    n_local = n // n_case
    row = mesh.coords()[case_axis]
    mine = range(row * n_local, (row + 1) * n_local)
    nus = torch.tensor(1.0 / res, dtype=spmd._nu.dtype, device=spmd.device)
    states = [spmd.local for _ in mine]
    st = case.settings

    def active(s) -> bool:
        return not (s.converged or s.diverged) and s.count < st.max_iterations

    def everyone():
        """(counts, converged | diverged, diverged) of all n cases, on
        every rank (one all_gather over the mesh)."""
        mine_t = torch.tensor([[s.count, s.converged or s.diverged, s.diverged]
                               for s in states], dtype=torch.float64,
                              device=spmd.device)
        whole = ring.all_gather(mine_t.unsqueeze(0), mesh)  # (ranks, n_local, 3)
        per_row = whole.reshape(n_case, n_x, n_local, 3)[:, 0].reshape(n, 3).cpu().numpy()
        return (per_row[:, 0].astype(np.int64), per_row[:, 1].astype(bool),
                per_row[:, 2].astype(bool))

    while True:
        for j, b in enumerate(mine):
            s = states[j]
            for _ in range(st.chunk_size):
                if not active(s):
                    break
                s, _counts = spmd._step(s, nus[b])
            states[j] = s
        counts, stopped, diverged = everyone()
        act = ~stopped & (counts < max_iterations)
        if verbose and ring.is_rank0():
            print(f"  spmd-sweep {nx}x{ny} ({n_case}x{n_x} mesh): iters "
                  f"{counts.min()}..{counts.max()}, {act.sum()}/{n} active")
        if not act.any():
            break

    # every case's bands to every rank: (ranks, n_local, 3, rows, ny + 2)
    bands = torch.stack([torch.stack([s.u, s.v, s.p]) for s in states])
    whole = ring.all_gather(bands.unsqueeze(0), mesh).reshape(
        n_case, n_x, n_local, 3, nx // n_x, ny + 2)
    # (case, var, nx, ny + 2): the x ranks' bands stacked along rows
    full = whole.permute(0, 2, 3, 1, 4, 5).reshape(n, 3, nx, ny + 2).cpu().numpy()
    fields = {
        float(re_val): {
            # bands hold all interior rows; strip the y ghosts, transpose to
            # the (ny, nx) HDF5/SR contract
            c: full[i, k, :, 1:-1].T.copy() for k, c in enumerate("uvp")
        }
        for i, re_val in enumerate(res)
        if not diverged[i]
    }
    if len(fields) < len(res):
        dropped = [float(r) for i, r in enumerate(res) if diverged[i]]
        if ring.is_rank0():
            print(f"  spmd-sweep {nx}x{ny}: DROPPED diverged cases Re={dropped}")
    return fields, counts.astype(np.int32)
