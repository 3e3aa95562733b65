"""The port's row-decomposed solver (`sr_for_cfd_tpu_torch/parallel/`) on
four gloo ranks against the JAX package's `SpmdSolver` on a four-device
mesh, on the CPU, from the same initial state.

The port's ranks are spawned processes (`spmd_ranks.py`), one spawn for
the whole file; JAX is imported in the test bodies only. Routes and
tolerances:

* `shardmap_solve_pressure` (one exchange per half-sweep), 32^2, float64:
  fields within 1e-10;
* the plain route, UPWIND cavity 32^2, float64, with an RRE jump taken:
  equal outer count, fields within 1e-10;
* `use_pallas=True`, `pressure_solver='sweeps'` (the per-rank sweep
  kernel's plain version on the CPU, JAX's kernel in interpret mode), the
  settings of `tests/test_parallel.py`'s Pallas SPMD tests with half their
  steps: the 32^2 cavity and the 32x16 BFS, float32: equal outer count,
  fields within 2e-5
  (float32 sums taken in other orders, and XLA:CPU contracts multiply-adds
  where the port does not).

Inner counts: on the kernel route every step's pressure sweeps equal those
of JAX's `SpmdSolver` (reported from inside its compiled chunk,
`spmd_jax.py`); the momentum counts of the first steps, and on the plain
route the pressure counts too, equal the JAX single-device solver's, which
JAX's `SpmdSolver` matches by construction (the same loops, exit tests and
cadence on globally summed residuals).

A one-rank run in a spawned child matches the port's single-device
`CFDSolver` bit for bit on the sweeps route and within 1e-12 on the
multigrid route (float64).
"""

import numpy as np
import pytest
import torch

import spmd_ranks
from spmd_jax import jax_single_device_counts, jax_spmd
from spmd_ranks import max_abs

torch.set_num_threads(1)

WORLD = 4
FIRST = 3  # steps whose momentum counts are held against the single-device solver
RRE_CAVITY = dict(Re=100, nx=32, ny=32, dt=8e-3, scheme="UPWIND", dtype="float64",
                  chunk_size=500, max_iterations=55, inner_max_iter=40,
                  convergence_criteria={"u": 1e-30, "v": 1e-30, "p": 1e-30},
                  rre_every=10, rre_depth=4, rre_min_count=10)
PALLAS_CAVITY = dict(Re=100, nx=32, ny=32, dt=2e-3, scheme="UPWIND", dtype="float32",
                     chunk_size=30, max_iterations=60, inner_max_iter=60,
                     use_pallas=True)
PALLAS_BFS = dict(Re=200, nx=32, ny=16, dt=2e-3, scheme="UPWIND", dtype="float32",
                  chunk_size=20, max_iterations=40, inner_max_iter=40, use_pallas=True)
HALO_KW = dict(dx=1 / 32, dy=1 / 32, dt=1e-3, rho=1.0, volp=1 / 32 ** 2, tol=1e-7,
               max_iter=400)
ONE_RANK = {
    "sweeps": dict(Re=100, nx=16, ny=16, dt=2e-3, scheme="QUICK", dtype="float64",
                   chunk_size=8, max_iterations=16),
    "multigrid": dict(Re=100, nx=32, ny=32, dt=2e-3, scheme="UPWIND", dtype="float64",
                      chunk_size=5, max_iterations=10, pressure_solver="multigrid"),
}


def _halo_inputs():
    g = np.random.default_rng(32)
    n = 32
    u, v = (g.standard_normal((n + 2, n + 2)) * 0.1 for _ in range(2))
    p0 = g.standard_normal((n + 2, n + 2)) * 0.01
    return u, v, p0


def _fluxes(u, v):
    """The face fluxes of (u, v), as numpy arrays (port's formula)."""
    from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes

    ff = face_fluxes(torch.as_tensor(u), torch.as_tensor(v), HALO_KW["dx"], HALO_KW["dy"])
    return [f.numpy() for f in ff]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    u, v, p0 = _halo_inputs()
    cases = {
        "halo": ("halo_pressure", dict(p=p0, ff=_fluxes(u, v), kw=HALO_KW)),
        "rre": ("solve_case", dict(maker="make_cavity_solver", kw=RRE_CAVITY)),
        "pallas_cavity": ("solve_case", dict(maker="make_cavity_solver",
                                             kw=PALLAS_CAVITY)),
        "pallas_bfs": ("solve_case", dict(maker="make_bfs_solver", kw=PALLAS_BFS)),
    }
    return spmd_ranks.run_ranks(tmp_path_factory.mktemp("spmd4"), WORLD, cases)


def test_halo_pressure_matches_jax(port):
    """One exchange per half-sweep: the port's ring (zeros on the open
    side) against JAX's wrapping ppermute, whose wrapped rows the boundary
    ranks discard."""
    import jax.numpy as jnp

    from sr_for_cfd_tpu.ops.stencil import FaceFluxes
    from sr_for_cfd_tpu.parallel.halo import shardmap_solve_pressure
    from sr_for_cfd_tpu.parallel.mesh import make_mesh

    u, v, p0 = _halo_inputs()
    ff = FaceFluxes(*(jnp.asarray(f) for f in _fluxes(u, v)))
    ref = np.asarray(shardmap_solve_pressure(jnp.asarray(p0), ff, make_mesh(WORLD, "x"),
                                             **HALO_KW))
    assert max_abs(port["halo"], ref) <= 1e-10
    np.testing.assert_array_equal(port["halo"][0], p0[0])


def test_plain_route_with_rre_matches_jax(port, monkeypatch):
    """Plain sweeps (exchange per block, stacked constants, psum'd rms),
    decomposed RRE with its jump taken at step 50, float64; the first
    steps' inner counts equal the single-device solver's."""
    count, fields, _ = jax_spmd("make_cavity_solver", RRE_CAVITY, WORLD, monkeypatch)
    got = port["rre"]
    assert got["rre_taken"] == 1
    assert got["count"] == count == 55
    assert got["per_step"][:FIRST] == jax_single_device_counts(
        "make_cavity_solver", RRE_CAVITY, FIRST)
    for k in "uvp":
        assert max_abs(got["fields"][k], fields[k]) <= 1e-10, k


@pytest.mark.parametrize("name,maker,kw", [
    ("pallas_cavity", "make_cavity_solver", PALLAS_CAVITY),
    ("pallas_bfs", "make_bfs_solver", PALLAS_BFS),
])
def test_kernel_route_matches_jax(port, monkeypatch, name, maker, kw):
    """use_pallas=True, pressure_solver='sweeps': the per-rank sweep (row
    9) in blocks of kb = 4 after one 8-row exchange, BFS inlet ghosts on
    rank 0, float32; every step's pressure sweeps equal JAX's, the first
    steps' momentum counts the single-device solver's."""
    count, fields, p_steps = jax_spmd(maker, kw, WORLD, monkeypatch)
    got = port[name]
    assert got["count"] == count
    assert [c["p"] for c in got["per_step"]] == p_steps
    assert len(p_steps) == count
    uv = [{k: c[k] for k in "uv"} for c in jax_single_device_counts(maker, kw, FIRST)]
    assert [{k: c[k] for k in "uv"} for c in got["per_step"][:FIRST]] == uv
    for k in "uvp":
        assert max_abs(got["fields"][k], fields[k]) <= 2e-5, k


def _warm_fields():
    g = np.random.default_rng(16)
    return {c: g.standard_normal((16, 16)) * 0.05 for c in "uvp"}


def test_one_rank_matches_single_device(tmp_path):
    """SpmdSolver on one gloo rank against CFDSolver on the same case: the
    sweeps and multigrid routes from the cold start, and a warm start at
    count 5 whose `.dat` pair rank 0 writes."""
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    cases = {k: ("solve_case", dict(maker="make_cavity_solver", kw=kw))
             for k, kw in ONE_RANK.items()}
    warm_kw = dict(ONE_RANK["sweeps"], max_iterations=12)
    cases["warm"] = ("warm_solve_save", dict(
        maker="make_cavity_solver", kw=warm_kw, fields=_warm_fields(), count=5,
        out_base=str(tmp_path / "spmd" / "cavity")))
    got = spmd_ranks.run_ranks(tmp_path, 1, cases)
    for name, kw in ONE_RANK.items():
        ref = make_cavity_solver(device="cpu", **kw)
        ref.solve(verbose=False, save_results=False)
        assert got[name]["count"] == ref.state.count
        tol = 0.0 if name == "sweeps" else 1e-12
        for k in "uvp":
            assert max_abs(got[name]["fields"][k], getattr(ref.state, k).numpy()) <= tol

    ref = make_cavity_solver(device="cpu", **warm_kw)
    ref.warm_start(_warm_fields(), count=5)
    ref.solve(str(tmp_path / "single" / "cavity"), verbose=False)
    count, fields = got["warm"]
    assert count == ref.state.count == 12
    for k in "uvp":
        np.testing.assert_array_equal(fields[k], ref.interior_fields()[k])
    for suffix in ("_full.dat", "_centerline.dat"):
        assert ((tmp_path / "spmd" / f"cavity{suffix}").read_text()
                == (tmp_path / "single" / f"cavity{suffix}").read_text())
