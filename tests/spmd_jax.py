"""The JAX package's solvers as references for the port's row-decomposed
solver, with the per-step inner counts that JAX's `SpmdSolver` keeps to
itself.

JAX's `SpmdSolver` returns no inner counts: its step drops the loop
counters inside the compiled chunk. `jax_spmd` recovers the pressure
solve's per-step counts without changing the JAX package: while the
solver is built and run, the functions its step looks up at trace time
are wrapped so that rank 0 reports each call through `jax.debug.callback`:

* the per-rank sweep kernel (`spmd_pallas.shard_rb_sweep`, the
  `use_pallas` sweeps route) reports its `kb` and its block's own rows of
  the frozen right-hand side. The calls of one step share that right-hand
  side and the next step's differs, so runs of equal right-hand sides
  split the calls into steps, and each step's sweeps are the sum of its
  `kb`s;
* the sharded V-cycle (`spmd_mg.make_spmd_mg_solve`'s solve, both
  multigrid routes) reports its cycle count, one call per step.

The chunk loop runs its steps one after another, so the reports come in
step order. The momentum counts, and the pressure counts of the plain
sweeps route, are not reachable this way: `jax_single_device_counts` gives
the JAX single-device solver's per-step counts for them.
"""

import functools

import numpy as np


def jax_spmd(maker, kw, world, monkeypatch):
    """JAX's SpmdSolver on `make_mesh(world, "x")` for `maker(**kw)`,
    solved: (count, global fields, per-step pressure counts or None)."""
    import jax

    from sr_for_cfd_tpu.parallel import spmd_mg, spmd_pallas
    from sr_for_cfd_tpu.parallel import spmd_step as jstep
    from sr_for_cfd_tpu.parallel.mesh import make_mesh
    from sr_for_cfd_tpu.solver import cases

    sweeps, cycles = [], []

    def on_sweep(row0, b_own, kb):
        if int(np.asarray(row0).ravel()[0]) == 0:
            sweeps.append((kb, np.asarray(b_own).tobytes()))

    def on_cycles(rank, n):
        if int(rank) == 0:
            cycles.append(int(n))

    sweep = spmd_pallas.shard_rb_sweep

    def reporting_sweep(ext, b_ext, row0, **kwargs):
        out = sweep(ext, b_ext, row0, **kwargs)
        h = kwargs["h"]
        jax.debug.callback(functools.partial(on_sweep, kb=kwargs["kb"]), row0,
                           b_ext[h:-h])
        return out

    make_solve = spmd_mg.make_spmd_mg_solve

    def reporting_make_solve(plan, axis, n_dev, **kwargs):
        solve = make_solve(plan, axis, n_dev, **kwargs)

        def reporting_solve(x, b):
            out, n = solve(x, b)
            jax.debug.callback(on_cycles, jax.lax.axis_index(axis), n)
            return out, n

        return reporting_solve

    monkeypatch.setattr(spmd_pallas, "shard_rb_sweep", reporting_sweep)
    monkeypatch.setattr(spmd_mg, "make_spmd_mg_solve", reporting_make_solve)
    # a fresh chunk cache, so that the step is traced with the wrappers
    monkeypatch.setattr(jstep, "_CHUNK_CACHE", {})
    solver = jstep.SpmdSolver(getattr(cases, maker)(**kw).case, make_mesh(world, "x"))
    local = solver.solve()
    fields = solver.global_fields()
    jax.effects_barrier()

    p = None
    if cycles:
        p = cycles
    elif sweeps:
        p, last = [], None
        for kb, rhs in sweeps:
            if rhs != last:
                p.append(0)
                last = rhs
            p[-1] += kb
    return int(local.count), fields, p


def jax_single_device_counts(maker, kw, steps):
    """The JAX single-device solver's {u, v, p} inner counts of its first
    `steps` steps from the cold start."""
    import jax

    from sr_for_cfd_tpu.solver import cases
    from sr_for_cfd_tpu.solver import simple as jsimple

    solver = getattr(cases, maker)(**kw)
    step = jax.jit(functools.partial(jsimple.simple_step, case=solver.case,
                                     profile=solver.profile, with_counts=True))
    s, out = solver.state, []
    for _ in range(steps):
        s, c = step(s)
        out.append({k: int(v) for k, v in c.items()})
    return out
