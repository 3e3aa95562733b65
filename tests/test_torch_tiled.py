"""The tiled red-black pressure sweep (`ops/tiled_kernels.py`), the
`pressure_solver="tiled"` path through the solver, and the `create_*`
entry points and top-level exports, against the JAX package on the CPU.

On a CPU tensor `tiled_solve_pressure` runs its plain version; the JAX
package runs its Pallas kernel in interpret mode. The card-side kernel is
held against the same plain version by tests/test_torch_cuda.py and
`chip_smoke.py`.

Tolerances (float32): XLA's CPU code contracts the Laplacian's sum and
`b - volp * Laplacian` into fused multiply-adds, the port (like the CUDA
kernel, built with -fmad=false) rounds each operation, so the fields
differ by about one ulp per sweep: measured 1.2e-7 of max|p| after 60
sweeps. The kernel parity tests take 1e-6 of max|p|. The solve tolerance
1e-5 is JAX's own test's, crossed away from the float32 floor.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_for_cfd_tpu
from sr_for_cfd_tpu.ops.pallas_tiled import tiled_solve_pressure as jax_tiled
from sr_for_cfd_tpu.ops.stencil import face_fluxes as jax_face_fluxes
from sr_for_cfd_tpu.ops.sweeps import optimal_sor
from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu.solver import simple as jsimple
import sr_for_cfd_tpu_torch
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes
from sr_for_cfd_tpu_torch.ops.tiled_kernels import tiled_solve_pressure
from sr_for_cfd_tpu_torch.solver import cases as tcases
from sr_for_cfd_tpu_torch.solver import simple as tsimple

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

KERNEL_RTOL = 1e-6


def _system(rng, n, lx=1.0, ly=1.0):
    """tests/test_pallas_tiled.py's seeded system, for both packages."""
    dx, dy = lx / n, ly / n
    u, v = (rng.standard_normal((n + 2, n + 2)) * 0.1 for _ in range(2))
    p0 = rng.standard_normal((n + 2, n + 2)) * 0.01
    jax_in = (jnp.asarray(p0, jnp.float32),
              jax_face_fluxes(jnp.asarray(u, jnp.float32),
                              jnp.asarray(v, jnp.float32), dx, dy))
    t = [torch.tensor(a, dtype=torch.float32) for a in (p0, u, v)]
    torch_in = (t[0], face_fluxes(t[1], t[2], dx, dy))
    return jax_in, torch_in, dict(dx=dx, dy=dy, dt=1e-3, rho=1.0, volp=dx * dy)


def _parity(jax_in, torch_in, geo, **kw):
    ref, n_ref = jax_tiled(*jax_in, return_count=True, interpret=True, **geo, **kw)
    kw.pop("slab_rows", None)
    out, n_out = tiled_solve_pressure(*torch_in, **geo, **kw)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=KERNEL_RTOL * np.abs(ref).max())
    assert n_out == int(n_ref)
    return out.numpy(), n_out


@pytest.mark.parametrize("n,slab", [(100, 32), (100, 64), (66, 32)])
def test_tiled_solve_matches_jax(rng, n, slab):
    """JAX's slab heights, dividing the row count and not: the port's loop
    has no slabs, and the result does not depend on them."""
    jax_in, torch_in, geo = _system(rng, n)
    _parity(jax_in, torch_in, geo, tol=1e-5, max_iter=60, slab_rows=slab)


def test_tiled_solve_anisotropic_keeps_ghosts(rng):
    jax_in, torch_in, geo = _system(rng, 64, lx=10.0, ly=3.0)
    out, _ = _parity(jax_in, torch_in, geo, tol=1e-5, max_iter=40, slab_rows=32)
    p0 = torch_in[0].numpy()
    for ring in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(out[ring], p0[ring])


def test_tiled_solve_clamps_omega(rng):
    """sor above optimal_sor(16, 16) ~ 1.67 is clamped, as in JAX: the
    result is the one at the optimum."""
    jax_in, torch_in, geo = _system(rng, 16)
    kw = dict(tol=1e-5, max_iter=50)
    out, n_out = _parity(jax_in, torch_in, geo, sor=1.99, **kw)
    at_opt, n_opt = tiled_solve_pressure(*torch_in, **geo, sor=optimal_sor(16, 16), **kw)
    np.testing.assert_array_equal(out, at_opt.numpy())
    assert n_out == n_opt


def test_tiled_cavity_path_matches_jax():
    """`make_cavity_solver(pressure_solver="tiled")` at 32^2 (UPWIND, Re=100,
    dt=2e-3, float32) for 200 steps in both packages: per-step u, v and
    pressure sweep counts equal, fields within 5e-6 of max|value| (measured
    4.7e-7 on p: the one-ulp FMA differences above, over 200 outer steps).
    Inner tolerance 1e-4: at the default 1e-6 the pressure solves end near
    the float32 floor, where one step in 60 ends a sweep apart in the two
    packages."""
    kw = dict(Re=100, nx=32, ny=32, dt=2e-3, scheme="UPWIND", dtype="float32",
              pressure_solver="tiled", inner_tolerance=1e-4)
    sj, st = jcases.make_cavity_solver(**kw), tcases.make_cavity_solver(device="cpu", **kw)
    jstep = jax.jit(functools.partial(jsimple.simple_step, case=sj.case,
                                      profile=sj.profile, with_counts=True))
    js, ts = sj.state, st.state
    for _ in range(200):
        js, jc = jstep(js)
        ts, tc = tsimple.simple_step(ts, st.case, st.profile, nu=st._nu,
                                     with_counts=True)
        assert tc == {k: int(v) for k, v in jc.items()}
    for c in "uvp":
        ref = np.asarray(getattr(js, c))
        np.testing.assert_allclose(getattr(ts, c).numpy(), ref, rtol=0,
                                   atol=5e-6 * np.abs(ref).max())


def _solve_both(jfn, tfn, tmp_path, **kw):
    """Run a JAX and a port entry point on the same arguments: equal
    iteration counts, fields within 1e-10, the port's two .dat files
    written under tmp_path."""
    js, jn, _ = jfn(output_name=str(tmp_path / "jax"), verbose=False,
                    save_results=False, **kw)
    ts, tn, _ = tfn(output_name=str(tmp_path / "run"), verbose=False, save_results=True,
                    device="cpu", **kw)
    assert tn == jn
    jf, tf = js.interior_fields(), ts.interior_fields()
    for c in "uvp":
        np.testing.assert_allclose(tf[c], jf[c], rtol=0, atol=1e-10)
    for suffix in ("_full.dat", "_centerline.dat"):
        assert (tmp_path / f"run{suffix}").stat().st_size > 0


def test_create_lid_driven_cavity_matches_jax(tmp_path):
    _solve_both(jcases.create_lid_driven_cavity, tcases.create_lid_driven_cavity,
                tmp_path, Re=100, nx=16, ny=16, dt=2e-3, dtype="float64",
                max_iterations=75)


def test_create_bfs_case_matches_jax(tmp_path):
    """With log_convergence=True both write the log; its iteration and rms
    columns agree (the last column is wall time)."""
    _solve_both(jcases.create_bfs_case, tcases.create_bfs_case, tmp_path,
                nx=12, ny=10, dtype="float64", max_iterations=75,
                log_convergence=True, chunk_size=25)

    def columns(path):
        rows = [line.split("\t") for line in path.read_text().splitlines()]
        return [r[:-1] if not r[0].startswith("#") else r for r in rows]

    t_log = columns(tmp_path / "run_convergence.log")
    assert t_log == columns(tmp_path / "jax_convergence.log")
    assert len([r for r in t_log if not r[0].startswith("#")]) == 3


def test_create_custom_case_matches_jax(tmp_path):
    """A double-lid cavity built from dicts (the lid on the bottom too)."""
    lid = {"type": "dirichlet", "value": 1.0}
    _solve_both(jcases.create_custom_case, tcases.create_custom_case, tmp_path,
                mesh_params=dict(nx=14, ny=12, lx=1.0, ly=1.0),
                fluid_params=dict(Re=100.0),
                solver_params=dict(dt=2e-3, dtype="float64", max_iterations=60,
                                   scheme="UPWIND"),
                bc_params={"u_boundaries": {"top": lid, "bottom": lid}})


def test_top_level_exports_match_jax():
    """Every name the JAX package exports at its top level, eagerly or
    lazily, is exported by the port, SpmdSolver, the padded-row
    ShardedSolver and the case-batched sharded solver included."""
    from sr_for_cfd_tpu_torch.parallel.domain import ShardedSolver
    from sr_for_cfd_tpu_torch.parallel.spmd_batch import batched_spmd_cavity_solve
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver

    assert sr_for_cfd_tpu_torch.SpmdSolver is SpmdSolver
    assert sr_for_cfd_tpu_torch.ShardedSolver is ShardedSolver
    assert sr_for_cfd_tpu_torch.batched_spmd_cavity_solve is batched_spmd_cavity_solve
    assert callable(sr_for_cfd_tpu_torch.SpmdSolver)
    public = [n for n, v in vars(sr_for_cfd_tpu).items()
              if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    lazy = ["SRModel", "ml_super_resolution", "run_hybrid_experiment",
            "batched_spmd_cavity_solve", "ShardedSolver"]
    for name in public + lazy:
        assert hasattr(sr_for_cfd_tpu_torch, name), name
        j = getattr(sr_for_cfd_tpu, name)
        t = getattr(sr_for_cfd_tpu_torch, name)
        assert callable(t) == callable(j), name
    from sr_for_cfd_tpu_torch import create_lid_driven_cavity

    assert create_lid_driven_cavity is tcases.create_lid_driven_cavity
