"""The port's padded-row decomposition (`parallel/domain.py`,
`mesh.grid_sharding`) and its collective census (`parallel/comm_budget.py`)
against the JAX package on the CPU: four gloo ranks (one spawn for the
file, `spmd_ranks.py`) against JAX on four of its eight virtual devices.

* `ShardedSolver` on the 30^2 UPWIND cavity in float64, the settings of
  `tests/test_parallel.py`'s GSPMD tests with 6 steps: nx + 2 = 32 splits
  into 8 padded rows a rank, so the bands are uneven (7, 8, 8, 7 interior
  rows) and nx % 4 != 0. Sweeps and multigrid: equal counts, u, v and p
  within 1e-12 of JAX's `ShardedSolver`. The kernel route
  (`use_pallas=True`, float32, row 9's plain version on the CPU) on the
  same uneven bands, sweeps and multigrid (level 0 smoothed on the bands
  through row 9's wrapper, the coarser levels replicated): bit-equal to
  the port's single-device solver.
* The refusals: a split that does not divide (JAX's message, word for
  word), `fused_step=True` and `pressure_solver='tiled'`.
* The census: one outer step on the ranks, each inner loop cut at two
  trips, on the cases that `tests/test_comm_budget.py` pins (the 400^2
  QUICK cavity on sweeps and on multigrid, the 40^2 kernel route). On the
  400^2 sweeps and the 64^2 multigrid cavity (two sharded levels) every
  inner loop's sites (halo and reductions) equal JAX's per trip, and the
  step's halo sites equal JAX's. The one mapping: JAX sums the three
  outer residuals in three scalar `psum`s, the port in one `all_reduce`
  of the three (12 bytes in both), so the port's step has one reduction
  call where JAX's has three. The pinned counts are checked on the port's
  census with that mapping.
"""

import numpy as np
import pytest
import torch

import spmd_ranks
from spmd_ranks import max_abs

torch.set_num_threads(1)

WORLD = 4
SHARDED = dict(Re=100, nx=30, ny=30, dt=2e-3, scheme="UPWIND", dtype="float64",
               chunk_size=3, max_iterations=6)
ROUTES = {"sweeps": SHARDED, "multigrid": dict(SHARDED, pressure_solver="multigrid")}
KERNEL = dict(SHARDED, dtype="float32", use_pallas=True)
UNEVEN = ((0, 7), (7, 8), (15, 8), (23, 7))
CENSUS = {
    "sweeps": dict(nx=400, ny=400, Re=1050),
    "multigrid": dict(nx=400, ny=400, Re=1050, pressure_solver="multigrid"),
    "kernel": dict(nx=40, ny=40, Re=100, use_pallas=True),
    # two sharded levels (16 and 8 rows a rank) before the replicated tail
    "multigrid_64": dict(nx=64, ny=64, Re=100, pressure_solver="multigrid"),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = {f"sharded_{k}": ("sharded_solve", dict(maker="make_cavity_solver", kw=kw))
             for k, kw in ROUTES.items()}
    cases["sharded_kernel"] = ("sharded_solve", dict(maker="make_cavity_solver", kw=KERNEL))
    cases["sharded_kernel_multigrid"] = ("sharded_solve", dict(
        maker="make_cavity_solver", kw=dict(KERNEL, pressure_solver="multigrid")))
    cases.update({f"census_{k}": ("chunk_census", dict(maker="make_cavity_solver", kw=kw))
                  for k, kw in CENSUS.items()})
    return spmd_ranks.run_ranks(tmp_path_factory.mktemp("domain4"), WORLD, cases)


def _jax_mesh():
    from sr_for_cfd_tpu.parallel.mesh import make_mesh

    return make_mesh(WORLD, "x")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_solver_matches_jax(port, route):
    """Uneven bands (7, 8, 8, 7 rows): the count and u, v, p within 1e-12
    of JAX's GSPMD `ShardedSolver`, which runs the single-device program."""
    from sr_for_cfd_tpu.parallel.domain import ShardedSolver
    from sr_for_cfd_tpu.solver.cases import make_cavity_solver

    state = ShardedSolver(make_cavity_solver(**ROUTES[route]).case, _jax_mesh()).solve()
    got = port[f"sharded_{route}"]
    assert got["bands"] == UNEVEN
    assert got["count"] == int(state.count) == SHARDED["max_iterations"]
    for k in "uvp":
        assert max_abs(got["fields"][k], np.asarray(getattr(state, k))) <= 1e-12, k


def test_sharded_kernel_route_on_uneven_bands(port):
    """use_pallas=True, float32: row 9's plain version on the uneven bands,
    bit-equal to the port's single-device solver (row 1's plain version),
    with its count."""
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    ref = make_cavity_solver(device="cpu", **KERNEL)
    ref.solve(verbose=False, save_results=False)
    got = port["sharded_kernel"]
    assert got["count"] == ref.state.count
    for k in "uvp":
        np.testing.assert_array_equal(got["fields"][k], getattr(ref.state, k).numpy())


def test_sharded_kernel_multigrid_on_uneven_bands(port):
    """use_pallas=True, float32, multigrid on the uneven bands: level 0's
    smoothing goes through row 9's wrapper on every rank (on the CPU its
    plain version), the gathered levels run replicated; bit-equal to the
    port's single-device solver (row 2's plain version), with its count,
    and a residual-history entry for each chunk."""
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    ref = make_cavity_solver(device="cpu", **dict(KERNEL, pressure_solver="multigrid"))
    ref.solve(verbose=False, save_results=False)
    got = port["sharded_kernel_multigrid"]
    assert got["bands"] == UNEVEN
    assert got["count"] == ref.state.count == SHARDED["max_iterations"]
    assert got["history"] == [3, 6]
    # each outer step smooths level 0 before and after every V-cycle
    assert got["row9_calls"] >= 2 * SHARDED["max_iterations"]
    for k in "uvp":
        np.testing.assert_array_equal(got["fields"][k], getattr(ref.state, k).numpy())


def test_grid_sharding_gives_each_rank_jax_s_rows():
    """Every rank's block of the padded rows equals JAX's
    `grid_sharding(...).devices_indices_map`, the bands are its interior
    rows, and `shard_state` cuts a whole state to them."""
    from sr_for_cfd_tpu.parallel.mesh import grid_sharding as jax_grid_sharding
    from sr_for_cfd_tpu_torch.parallel import domain, mesh
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    n = SHARDED["nx"] + 2
    whole = mesh.Mesh(range(WORLD), ("x",), (WORLD,))
    jmesh = _jax_mesh()
    index = jax_grid_sharding(jmesh).devices_indices_map((n, n))
    want = [index[d][0] for d in jmesh.devices.ravel()]
    assert mesh.grid_sharding(whole).blocks(n) == want
    assert domain.padded_bands(mesh.grid_sharding(whole), n - 2) == UNEVEN
    # this process is rank 0: `shard_state` gives it the interior rows of
    # its padded block, rows 1..7 of the padded field
    state = make_cavity_solver(device="cpu", **SHARDED).state
    local = domain.shard_state(state, whole)
    assert torch.equal(local.u, state.u[1:8]) and torch.equal(local.ff.e, state.ff.e[:7])


def test_uneven_split_refused_like_jax():
    """nx + 2 = 17 over 8 ranks: JAX's message, word for word."""
    from sr_for_cfd_tpu.parallel.domain import ShardedSolver as JaxSharded
    from sr_for_cfd_tpu.parallel.mesh import make_mesh
    from sr_for_cfd_tpu.solver.cases import make_cavity_solver as jax_cavity
    from sr_for_cfd_tpu_torch.parallel import mesh
    from sr_for_cfd_tpu_torch.parallel.domain import ShardedSolver
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    with pytest.raises(ValueError, match="divide evenly") as want:
        JaxSharded(jax_cavity(Re=100, nx=15, ny=15).case, make_mesh(8, "x"))
    with pytest.raises(ValueError, match="divide evenly") as got:
        ShardedSolver(make_cavity_solver(Re=100, nx=15, ny=15, device="cpu").case,
                      mesh.Mesh(range(8), ("x",), (8,)), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("settings, named", [
    (dict(fused_step=True, dtype="float32"), "fused_step=True"),
    (dict(pressure_solver="tiled", dtype="float32"), "pressure_solver='tiled'"),
], ids=["fused_step", "tiled"])
def test_settings_the_step_cannot_decompose_are_refused(settings, named):
    """What the row-decomposed step cannot run is refused with the setting
    named, not run on a replicated whole grid."""
    from sr_for_cfd_tpu_torch.parallel import mesh
    from sr_for_cfd_tpu_torch.parallel.domain import ShardedSolver
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    case = make_cavity_solver(Re=100, nx=30, ny=30, device="cpu", **settings).case
    with pytest.raises(ValueError, match=named.replace("(", r"\(")):
        ShardedSolver(case, mesh.Mesh(range(WORLD), ("x",), (WORLD,)), device="cpu")


def _halo(sites):
    return sorted((s.payload_bytes, s.calls) for s in sites if s.name.startswith("ppermute"))


def _reduce(sites):
    return sorted((s.name.split("_")[0], s.payload_bytes, s.calls) for s in sites
                  if not s.name.startswith("ppermute"))


@pytest.mark.parametrize("route", ["multigrid_64", "sweeps"])
def test_census_matches_jax(port, route):
    """Per trip of each inner loop: every site equal to JAX's. The step:
    halo sites equal, JAX's three 4-byte residual psums one 12-byte psum."""
    from sr_for_cfd_tpu.parallel.comm_budget import spmd_chunk_census as jax_census
    from sr_for_cfd_tpu.solver.cases import make_cavity_solver

    want = jax_census(make_cavity_solver(**CENSUS[route]).case, _jax_mesh())
    got = port[f"census_{route}"]
    assert len(got.loops) == len(want.loops) == 3
    for g, w in zip(got.loops, want.loops):
        assert _halo(g.sites) == _halo(w.sites)
        assert _reduce(g.sites) == _reduce(w.sites)
        assert g.per_trip_by_kind() == w.per_trip_by_kind()
    assert _halo(got.sites) == _halo(want.sites)
    assert _reduce(want.sites) == [("psum", 4, 3)]
    assert _reduce(got.sites) == [("psum", 12, 1)]


def test_census_pins_of_the_jax_package(port):
    """The per-step counts that `tests/test_comm_budget.py` pins, on the
    port's census (its one residual reduction for JAX's three)."""
    from sr_for_cfd_tpu_torch.parallel.comm_budget import step_traffic
    from sr_for_cfd_tpu_torch.parallel.spmd_mg import plan_spmd_mg
    from sr_for_cfd_tpu_torch.parallel.spmd_step import sweep_blocks
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    case = make_cavity_solver(device="cpu", **CENSUS["sweeps"]).case
    st = case.settings
    rows = 400 // WORLD
    trips = {"u": 3.0 * st.momentum_check_every, "v": 3.0 * st.momentum_check_every,
             "p": 48.0}
    t = step_traffic(port["census_sweeps"], trips, case)
    mom = 2 * len(sweep_blocks(st.momentum_check_every, (rows - 1) // 2))
    prs = 2 * len(sweep_blocks(st.pressure_check_every, rows // 2))
    assert t["halo_calls_per_step"] == pytest.approx(
        12.0 + 3.0 * mom * 2 + (48.0 / st.pressure_check_every) * prs)
    assert t["reduce_calls_per_step"] == pytest.approx(
        1.0 + 3.0 * 2 + 48.0 / st.pressure_check_every)
    assert t["calls_per_step"] < 60.0

    kernel = make_cavity_solver(device="cpu", **CENSUS["kernel"]).case
    p_loop = port["census_kernel"].loops[2]
    assert p_loop.per_trip_by_kind()["halo"][1] == 2 * len(
        sweep_blocks(kernel.settings.pressure_check_every, 40 // WORLD // 2))

    m = make_cavity_solver(device="cpu", **CENSUS["multigrid"]).case.mesh
    n_shard = plan_spmd_mg(m.nx, m.ny, m.dx, m.dy, m.volp, WORLD, np.dtype("float32")).n_shard
    halo_calls = port["census_multigrid"].loops[2].per_trip_by_kind()["halo"][1]
    assert 6 * n_shard <= halo_calls <= 10 * n_shard + 4
